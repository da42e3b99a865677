"""CLI entry points: dfget / dfcache / dfstore equivalents.

Capability parity with client/dfget (single-URL P2P download with
back-source fallback, dfget.go:47-141), client/dfcache (stat/import/
export/delete of cached tasks, dfcache.go) and client/dfstore's
GetObject/PutObject surface (dfstore.go) re-pointed at local task storage
(the object-storage daemon API is served by manager-lite; this CLI covers
the file-path surface). One binary, subcommands — `python -m
dragonfly2_tpu_torch.client.cli <cmd>`.

Port of dragonfly2_tpu/client/cli.py, whole; no path of it imports
torch.
"""

from __future__ import annotations

import argparse
import asyncio
import pathlib
import sys

from dragonfly2_tpu_torch.client.daemon import Daemon
from dragonfly2_tpu_torch.client.piece_manager import piece_layout
from dragonfly2_tpu_torch.client.storage import StorageManager, TaskMetadata
from dragonfly2_tpu_torch.utils import idgen
from dragonfly2_tpu_torch.utils.digest import md5_from_bytes, sha256_from_reader


def _parse_scheduler(value: str) -> tuple[str, int]:
    host, _, port = value.rpartition(":")
    return host or "127.0.0.1", int(port)


def _parse_headers(pairs: list[str]) -> dict[str, str] | None:
    headers = {}
    for pair in pairs:
        key, sep, value = pair.partition(":")
        if not sep or not key.strip():
            raise SystemExit(f"--header needs 'Key: Value', got {pair!r}")
        headers[key.strip()] = value.strip()
    return headers or None


async def _dfget(args) -> int:
    daemon = Daemon(
        data_dir=args.data_dir,
        scheduler_addresses=[_parse_scheduler(s) for s in args.scheduler],
        ip=args.ip,
    )
    await daemon.start()
    try:
        headers = _parse_headers(args.header)
        if args.recursive:
            return await _recursive_download(daemon, args, headers)
        ts = await daemon.download(
            args.url,
            tag=args.tag,
            application=args.application,
            piece_length=args.piece_length,
            back_source_allowed=not args.no_back_source,
            headers=headers,
        )
        await daemon.export_file(ts, args.output)
        print(f"downloaded {ts.meta.content_length} bytes -> {args.output}")
        return 0
    finally:
        await daemon.stop()


def _accept(url: str, accept_regex: str, reject_regex: str) -> bool:
    """Reject wins; then the accept filter must match if set
    (dfget.go accept()/reject(), :296-314)."""
    import re

    if reject_regex and re.search(reject_regex, url):
        return False
    if accept_regex and not re.search(accept_regex, url):
        return False
    return True


async def _recursive_download(daemon, args, headers: dict | None = None) -> int:
    """Breadth-first directory download (recursiveDownload,
    client/dfget/dfget.go:316-387): pop a directory, list its children via
    the source registry, enqueue subdirectories (bounded by --level, 0 =
    unlimited), filter files by --accept-regex/--reject-regex, download
    each to output joined with its name. --list prints instead of
    downloading. Re-listing an already-seen URL is deduped; cycle safety
    for file:// trees comes from FileSource.list_entries refusing to
    descend into directory symlinks (each hop through a link cycle would
    mint a new, longer URL the dedup set can never catch), and --level
    bounds pathological ever-deepening http autoindexes."""
    from collections import deque

    from dragonfly2_tpu_torch.client import source as source_mod

    root_out = pathlib.Path(args.output)
    queue = deque([(args.url, root_out, args.level)])
    visited: set[str] = set()
    failures = 0
    while queue:
        url, out_dir, level = queue.popleft()
        if args.level and level == 0:
            print(f"{url}: recursion level reached, skip", file=sys.stderr)
            continue
        if url in visited:
            continue
        visited.add(url)
        try:
            entries = source_mod.list_entries(url, headers)
        except Exception as e:  # noqa: BLE001 - keep walking other subtrees
            print(f"list {url}: {e}", file=sys.stderr)
            failures += 1
            continue
        for entry in entries:
            if "/" in entry.name or entry.name in ("", ".", ".."):
                # defense against hostile autoindexes: an entry name that
                # is a path (or '..') could escape the --output root
                print(f"skip suspicious entry {entry.url!r}", file=sys.stderr)
                continue
            child_out = out_dir / entry.name
            if entry.is_dir:
                # accept/reject filter files only — pruning directories here
                # would silently drop matching files deeper in the tree
                queue.append((entry.url, child_out, level - 1))
                continue
            if not _accept(entry.url, args.accept_regex, args.reject_regex):
                continue
            print(str(child_out.relative_to(root_out)))
            if args.list:
                continue
            try:
                ts = await daemon.download(
                    entry.url,
                    tag=args.tag,
                    application=args.application,
                    piece_length=args.piece_length,
                    back_source_allowed=not args.no_back_source,
                    headers=headers,
                )
                child_out.parent.mkdir(parents=True, exist_ok=True)
                await daemon.export_file(ts, str(child_out))
            except Exception as e:  # noqa: BLE001
                print(f"download {entry.url}: {e}", file=sys.stderr)
                failures += 1
    return 0 if failures == 0 else 1


def _dfcache(args) -> int:
    storage = StorageManager(args.data_dir)
    if args.action == "stat":
        ts = storage.get(args.task_id)
        if ts is None:
            print("not found", file=sys.stderr)
            return 1
        print(
            f"task {ts.meta.task_id}: done={ts.meta.done} "
            f"pieces={ts.meta.finished_count()}/{ts.meta.total_pieces} "
            f"bytes={ts.meta.content_length}"
        )
        return 0
    if args.action == "delete":
        return 0 if storage.delete_task(args.task_id) else 1
    if args.action == "export":
        ts = storage.find_completed_task(args.task_id)
        if ts is None:
            print("task not completed locally", file=sys.stderr)
            return 1
        pathlib.Path(args.output).write_bytes(ts.data_path.read_bytes())
        return 0
    if args.action == "import":
        data = pathlib.Path(args.path).read_bytes()
        task_id = args.task_id or idgen.task_id_v1(f"file://{pathlib.Path(args.path).resolve()}")
        ts = storage.register_task(TaskMetadata(task_id=task_id, peer_id="import"))
        layout = piece_layout(len(data), ts.meta.piece_length)
        for n, off, length in layout:
            ts.write_piece(n, off, data[off : off + length], digest=md5_from_bytes(data[off : off + length]))
        ts.mark_done(len(data), len(layout))
        print(task_id)
        return 0
    raise AssertionError(args.action)


def _dfstore(args) -> int:
    if getattr(args, "endpoint", ""):
        return _dfstore_remote(args)
    storage = StorageManager(args.data_dir)
    if args.action == "get":
        ts = storage.find_completed_task(args.task_id)
        if ts is None:
            print("not found", file=sys.stderr)
            return 1
        sys.stdout.buffer.write(ts.data_path.read_bytes())
        return 0
    if args.action == "put":
        ns = argparse.Namespace(
            action="import", data_dir=args.data_dir, path=args.path, task_id=args.task_id
        )
        return _dfcache(ns)
    if args.action == "sum":
        ts = storage.get(args.task_id)
        if ts is None:
            return 1
        with open(ts.data_path, "rb") as f:
            print(sha256_from_reader(f))
        return 0
    raise AssertionError(args.action)


def _dfstore_remote(args) -> int:
    """dfstore against a daemon's object-storage HTTP API
    (client/dfstore/dfstore.go wraps exactly this surface)."""
    from dragonfly2_tpu_torch.objectstorage.service import DfstoreClient
    from dragonfly2_tpu_torch.utils import dferrors

    client = DfstoreClient(args.endpoint)
    try:
        if args.action == "get":
            sys.stdout.buffer.write(client.get_object(args.bucket, args.key))
            return 0
        if args.action == "put":
            client.put_object(args.bucket, args.key, pathlib.Path(args.path).read_bytes())
            return 0
        if args.action == "sum":
            meta = client.object_metadatas(args.bucket, prefix=args.key)
            for m in meta:
                print(m["etag"] or m["content_length"], m["key"])
            return 0
    except dferrors.NotFound as e:
        print(e, file=sys.stderr)
        return 1
    raise AssertionError(args.action)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dragonfly2-tpu-client")
    sub = parser.add_subparsers(dest="cmd", required=True)

    get = sub.add_parser("dfget", help="download a URL through the P2P mesh")
    get.add_argument("url")
    get.add_argument("-o", "--output", required=True)
    get.add_argument("--scheduler", action="append", required=True, help="host:port")
    get.add_argument("--data-dir", default=".dfget-data")
    get.add_argument("--ip", default="127.0.0.1")
    get.add_argument("--tag", default="")
    get.add_argument("--application", default="")
    get.add_argument("--piece-length", type=int, default=4 << 20)
    get.add_argument("--no-back-source", action="store_true")
    get.add_argument(
        "-H", "--header", action="append", default=[], metavar="'Key: Value'",
        help="request header forwarded to the back-source client "
        "(repeatable; dfget --header / urlMeta.Header in the reference — "
        "auth tokens, x-df-* object-store credentials)",
    )
    get.add_argument(
        "-r", "--recursive", action="store_true",
        help="treat URL as a directory and download it breadth-first",
    )
    get.add_argument(
        "--level", type=int, default=0,
        help="max directory depth to recurse into (0 = unlimited)",
    )
    get.add_argument("--accept-regex", default="", help="only fetch matching URLs")
    get.add_argument("--reject-regex", default="", help="skip matching URLs")
    get.add_argument(
        "--list", action="store_true",
        help="with --recursive: print the would-be downloads, fetch nothing",
    )

    cache = sub.add_parser("dfcache", help="local task cache ops")
    cache.add_argument("action", choices=("stat", "import", "export", "delete"))
    cache.add_argument("--data-dir", default=".dfget-data")
    cache.add_argument("--task-id", default="")
    cache.add_argument("--path", default="")
    cache.add_argument("-o", "--output", default="")

    store = sub.add_parser("dfstore", help="object-ish get/put over task storage")
    store.add_argument("action", choices=("get", "put", "sum"))
    store.add_argument("--data-dir", default=".dfget-data")
    store.add_argument("--task-id", default="")
    store.add_argument("--path", default="")
    store.add_argument("--endpoint", default="", help="daemon object-storage URL")
    store.add_argument("--bucket", default="")
    store.add_argument("--key", default="")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "dfget":
        return asyncio.run(_dfget(args))
    if args.cmd == "dfcache":
        return _dfcache(args)
    if args.cmd == "dfstore":
        return _dfstore(args)
    raise AssertionError(args.cmd)


if __name__ == "__main__":
    sys.exit(main())
