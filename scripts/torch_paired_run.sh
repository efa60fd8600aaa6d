#!/usr/bin/env bash
# Compare two trees of the PyTorch/CUDA port on one CUDA card, in one
# run: chip_smoke.py of each tree in the order parent, change, change,
# parent, then scripts/torch_kernel_plans.py of the change tree.
#
#   scripts/torch_paired_run.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# PARENT_DIR and CHANGE_DIR are checkouts (for example unpacked with
# `git archive`); each builds its kernels into its own _build directory.
# Each run's full output goes to OUT_DIR/<run>.txt (parent1, change1,
# change2, parent2, plans), and the lines that PERF.md reads are printed:
# each kernel's wrapper and device times, each phase's wall and device
# busy time, and the plan and count measurements. Exits non-zero if any
# run failed.
set -uo pipefail

if [ $# -ne 3 ]; then
  echo "usage: $0 PARENT_DIR CHANGE_DIR OUT_DIR" >&2
  exit 2
fi
parent=$(cd "$1" && pwd) change=$(cd "$2" && pwd)
mkdir -p "$3" && out=$(cd "$3" && pwd)
failed=0

run() {  # name dir command...
  local name=$1 dir=$2
  shift 2
  local t0=$SECONDS
  (cd "$dir" && "$@") >"$out/$name.txt" 2>&1
  local rc=$?
  echo "== $name: rc $rc, $((SECONDS - t0)) s"
  [ $rc -eq 0 ] || failed=1
}

for step in parent:1 change:1 change:2 parent:2; do
  tree=${step%%:*}
  dir=$parent
  [ "$tree" = change ] && dir=$change
  run "$tree${step##*:}" "$dir" python3 chip_smoke.py
  grep -E "^card:|wrapper .* ms/call|ms  x|device busy|^Phase [AB]:" \
    "$out/$tree${step##*:}.txt" | cut -c1-200
done
run plans "$change" python3 scripts/torch_kernel_plans.py
grep -E "^(card|build|K1|K2)" "$out/plans.txt" | cut -c1-400
exit $failed
