#!/bin/bash
# Repeat chip_smoke.py's runs on the card, each in a fresh HOME and TMPDIR,
# and print one line a run: "RUN <name> rc <exit code> seconds <wall>",
# then the run's preheat, planet and failure lines. Each run's whole
# output goes to OUT/<name>.log.
#
#   bash tools/chip_repeat.sh TREE OUT
#
# TREE is a checkout to run from (an unpacked `git archive`), copied
# afresh for each run, so that no run reuses another's kernel build; OUT a
# directory for the logs. The counts come from the environment:
#   N18     runs of phase 18 alone (chip_smoke.phase_objects)      default 0
#   N19     runs of phase 19 (d) alone (chip_smoke._scale_procday) default 0
#   NWHOLE  runs of the whole script                               default 0
#   ALONE   1: then run chip_smoke.py alone in a directory without
#           the package (the contract's required failure)          default 0
set -u
tree=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
scratch=$(mktemp -d)
trap 'rm -rf "$scratch"' EXIT
cd "$tree"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
run() {  # name, command...
  local name=$1 home tmp copy start end rc
  shift
  home=$(mktemp -d -p "$scratch") tmp=$(mktemp -d -p "$scratch") copy=$(mktemp -d -p "$scratch")
  cp -a "$tree/." "$copy/"
  rm -rf "$copy/dragonfly2_tpu_torch/_build"
  start=$(date +%s%N)
  (cd "$copy" && HOME=$home TMPDIR=$tmp timeout 1250 "$@" > "$out/$name.log" 2>&1)
  rc=$?
  end=$(date +%s%N)
  rm -rf "$copy" "$home" "$tmp"
  echo "RUN $name rc $rc seconds $(awk -v a="$start" -v b="$end" 'BEGIN{printf "%.1f", (b - a) / 1e9}')"
  grep -E "^objects: preheat|proxies answered|^scale procday|verdict_match|phase: [0-9.]+ s|^phases: |^build: |FAILED" \
    "$out/$name.log" | cut -c1-700
  tail -n 1 "$out/$name.log"
}
for i in $(seq 1 "${N18:-0}"); do
  run "phase18_$i" python3 -c "import chip_smoke as c; c.phase_objects(c.phase_device(), '.')"
done
for i in $(seq 1 "${N19:-0}"); do
  run "phase19d_$i" python3 -c "from dragonfly2_tpu_torch import native; native.ensure_built(); \
import chip_smoke as c; c._scale_procday(c.phase_device(), 'cuda')"
done
for i in $(seq 1 "${NWHOLE:-0}"); do
  run "whole_$i" python3 chip_smoke.py
done
if [ "${ALONE:-0}" = 1 ]; then
  alone=$(mktemp -d -p "$scratch")
  cp chip_smoke.py "$alone/"
  (cd "$alone" && python3 chip_smoke.py > "$out/alone.log" 2>&1; echo "RUN alone rc $?")
  tail -n 2 "$out/alone.log"
fi
