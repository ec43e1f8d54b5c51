#!/bin/bash
# Time chip_smoke.py of two checkouts on one card, in the order parent,
# change, change, parent, each from a clean kernel build, so that both share
# the host's speed and the build cost.
#
#   bash protstruc_tpu_torch/experiments/smoke_ab.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# Each run's output goes to OUT_DIR/ab_<n>_<parent|change>.log.  Prints the
# card's name and power limit, each run's exit code and milliseconds, its
# phases' "ok in" seconds and its last line; exits non-zero if a run failed.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
i=0
fail=0
for t in parent change change parent; do
  i=$((i + 1))
  dir=${!t}
  log="$out/ab_${i}_$t.log"
  rm -rf "$dir/protstruc_tpu_torch/_build"
  s=$(date +%s%N)
  (cd "$dir" && python3 chip_smoke.py > "$log" 2>&1)
  rc=$?
  e=$(date +%s%N)
  echo "run $i $t rc=$rc ms=$(( (e - s) / 1000000 ))"
  grep -E "^phase [0-9]+[^:]*: ok in [0-9.]+ s" "$log" | sed -E 's/^(phase [0-9]+)[^:]*: ok in ([0-9.]+) s.*/  \1 \2 s/'
  tail -n 1 "$log"
  [ "$rc" -ne 0 ] && fail=1
done
exit $fail
