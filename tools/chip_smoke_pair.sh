#!/bin/bash
# The whole chip_smoke.py of two source trees of the port, one after the
# other on one card, each from its own directory (git archive of a commit
# or of `git write-tree`), its command time by the host clock.
#
#   bash tools/chip_smoke_pair.sh build/parent build/change build/pair
#
# Each run's output goes to OUT_parent.log / OUT_change.log; each tree's
# build/ (its compiled kernels) is removed after its run.  Prints one line
# per run: "<which> rc=<exit code> secs=<command seconds>".
set -o pipefail
parent=$(cd "$1" && pwd); change=$(cd "$2" && pwd); out=$(realpath -m "$3")
mkdir -p "$(dirname "$out")"
for which in parent change; do
  dir=$parent; [ "$which" = change ] && dir=$change
  s=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py > "${out}_${which}.log" 2>&1)
  rc=$?
  echo "$which rc=$rc secs=$(( $(date +%s) - s ))"
  tail -c 300 "${out}_${which}.log"
  rm -rf "$dir/build"
done
