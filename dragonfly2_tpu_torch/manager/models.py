"""Manager durable state: sqlite-backed document tables.

Port of dragonfly2_tpu/manager/models.py, whole: the same tables, unique indexes and JSON
documents, so either package opens the other's SQLite file.

Capability parity with manager/models/*.go + manager/database/database.go
(GORM schemas over MySQL/Postgres): the same entity set — users, oauth,
clusters, scheduler-clusters, schedulers, seed-peer-clusters, seed-peers,
peers, buckets, configs, jobs, applications, models, personal-access-tokens,
casbin rules — stored as JSON documents in sqlite with expression-indexed
unique keys (sqlite is in the image; a SQL server is not). BaseModel fields
(id, created_at, updated_at — manager/models/models.go) live as real
columns; everything else rides in the `data` JSON column so schema parity
with the reference's GORM tags needs no migration tooling.
"""

from __future__ import annotations

import json
import re
import sqlite3
import threading
import time
from typing import Any, Iterable

# Filter keys are interpolated into json_extract paths; restrict them to
# plain identifiers so caller-supplied keys cannot break out of the quoted
# JSON path (the values always go through placeholders).
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")

# table name -> tuple of JSON paths forming the unique key
# (mirrors the reference's `uk_*` unique indexes, e.g.
# manager/models/scheduler.go `index:uk_scheduler,unique` on
# host_name+ip+scheduler_cluster_id).
TABLES: dict[str, tuple[str, ...]] = {
    "users": ("name",),
    "oauth": ("name",),
    "clusters": ("name",),
    "scheduler_clusters": ("name",),
    "schedulers": ("host_name", "ip", "scheduler_cluster_id"),
    "seed_peer_clusters": ("name",),
    "seed_peers": ("host_name", "ip", "seed_peer_cluster_id"),
    "peers": ("host_name", "ip"),
    "buckets": ("name",),
    "configs": ("name",),
    "jobs": (),
    "applications": ("name",),
    "models": ("model_id", "version"),
    "personal_access_tokens": ("token",),
    "casbin_rules": (),
}


class DuplicateRecord(ValueError):
    pass


class RecordNotFound(KeyError):
    pass


class Database:
    """One sqlite file (or ':memory:') holding every manager table."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL") if path != ":memory:" else None
        self._mu = threading.RLock()
        self._migrate()

    def _migrate(self) -> None:
        with self._mu:
            for table, unique in TABLES.items():
                self._conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {table} ("
                    "id INTEGER PRIMARY KEY AUTOINCREMENT,"
                    "created_at REAL NOT NULL,"
                    "updated_at REAL NOT NULL,"
                    "data TEXT NOT NULL)"
                )
                if unique:
                    cols = ",".join(f"json_extract(data,'$.{k}')" for k in unique)
                    self._conn.execute(
                        f"CREATE UNIQUE INDEX IF NOT EXISTS uk_{table} ON {table} ({cols})"
                    )
            self._conn.commit()

    def close(self) -> None:
        with self._mu:
            self._conn.close()

    # ----------------------------------------------------------------- CRUD

    def create(self, table: str, data: dict) -> dict:
        now = time.time()
        with self._mu:
            try:
                cur = self._conn.execute(
                    f"INSERT INTO {table} (created_at, updated_at, data) VALUES (?,?,?)",
                    (now, now, json.dumps(data)),
                )
            except sqlite3.IntegrityError as e:
                raise DuplicateRecord(f"{table}: duplicate record: {e}") from e
            self._conn.commit()
            return self.get(table, cur.lastrowid)

    def get(self, table: str, record_id: int) -> dict:
        with self._mu:
            row = self._conn.execute(
                f"SELECT id, created_at, updated_at, data FROM {table} WHERE id=?",
                (record_id,),
            ).fetchone()
        if row is None:
            raise RecordNotFound(f"{table}/{record_id} not found")
        return _hydrate(row)

    def update(self, table: str, record_id: int, patch: dict) -> dict:
        with self._mu:
            record = self.get(table, record_id)
            data = {k: v for k, v in record.items() if k not in ("id", "created_at", "updated_at")}
            data.update(patch)
            try:
                self._conn.execute(
                    f"UPDATE {table} SET updated_at=?, data=? WHERE id=?",
                    (time.time(), json.dumps(data), record_id),
                )
            except sqlite3.IntegrityError as e:
                raise DuplicateRecord(f"{table}: duplicate record: {e}") from e
            self._conn.commit()
            return self.get(table, record_id)

    def delete(self, table: str, record_id: int) -> None:
        with self._mu:
            cur = self._conn.execute(f"DELETE FROM {table} WHERE id=?", (record_id,))
            self._conn.commit()
        if cur.rowcount == 0:
            raise RecordNotFound(f"{table}/{record_id} not found")

    def list(
        self,
        table: str,
        where: dict | None = None,
        page: int = 1,
        per_page: int = 100,
    ) -> list[dict]:
        """Filtered scan; `where` matches top-level JSON fields exactly
        (the reference's GORM `Where(&model)` query-by-example)."""
        clauses, params = [], []
        for key, value in (where or {}).items():
            if not _IDENT.fullmatch(key):
                raise ValueError(f"bad filter key {key!r}")
            expr = f"json_extract(data,'$.{key}')"
            # SQLite compares 1 = '1' as FALSE, and REST query params
            # arrive as strings — a numeric-looking string filter must
            # still match integer-typed JSON fields (the reference's GORM
            # binding is typed by the model and converts; this store is
            # schemaless, so match either representation)
            if isinstance(value, str):
                try:
                    as_num = int(value)
                except ValueError:
                    clauses.append(f"{expr} = ?")
                    params.append(value)
                else:
                    clauses.append(f"({expr} = ? OR {expr} = ?)")
                    params += [value, as_num]
            else:
                clauses.append(f"{expr} = ?")
                params.append(value)
        sql = f"SELECT id, created_at, updated_at, data FROM {table}"
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY id LIMIT ? OFFSET ?"
        params += [per_page, (max(page, 1) - 1) * per_page]
        with self._mu:
            rows = self._conn.execute(sql, params).fetchall()
        return [_hydrate(r) for r in rows]

    def find_one(self, table: str, where: dict) -> dict | None:
        rows = self.list(table, where, per_page=1)
        return rows[0] if rows else None

    def count(self, table: str) -> int:
        with self._mu:
            (n,) = self._conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()
        return n

    # --------------------------------------------------------------- casbin

    def add_rule(self, ptype: str, *fields: str) -> None:
        self.create("casbin_rules", {"ptype": ptype, "fields": list(fields)})

    def rules(self, ptype: str | None = None) -> Iterable[tuple[str, list[str]]]:
        for row in self.list("casbin_rules", per_page=100000):
            if ptype is None or row["ptype"] == ptype:
                yield row["ptype"], row["fields"]

    def remove_rules(self, ptype: str, prefix: list[str]) -> int:
        """Delete rules whose leading fields equal `prefix`."""
        removed = 0
        for row in self.list("casbin_rules", where={"ptype": ptype}, per_page=100000):
            if row["fields"][: len(prefix)] == prefix:
                self.delete("casbin_rules", row["id"])
                removed += 1
        return removed


def _hydrate(row: tuple[Any, ...]) -> dict:
    record_id, created_at, updated_at, data = row
    record = json.loads(data)
    record["id"] = record_id
    record["created_at"] = created_at
    record["updated_at"] = updated_at
    return record
