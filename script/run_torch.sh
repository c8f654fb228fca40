#!/bin/bash
# The reference-parity sweep of one set and op on the port (PyTorch +
# CUDA), on one NVIDIA card:
#
#   bash script/run_torch.sh <set> <op> [cluster]     set: A B C D M
#                                                      op: hmult hadd hrotate
#                                                          pmult padd
#
#   cluster absent or 1 -> the measured single-card sweep at every level
#                          from the set's maxLevel down to 2
#                          (scripts/sweep_torch.py --levels all), one JSON
#                          line a level in outLogs/<set>/<op>_torch.jsonl.
#   cluster N > 1       -> the port's sharded dispatch on N shards of this
#                          card (python -m homulator_tpu_torch run ...
#                          <cluster> --verify --device cuda) at the levels
#                          {max, 3/4, 1/2, 1/4, 2}: hmult and hrotate on the
#                          limb and coeff dispatches, and on the hybrid at
#                          an even cluster of 4 or more; the other ops on
#                          auto. Logs in outLogs/<set>/c<cluster>/<op>_torch.log.
#
# The port's counterpart of script/common.sh's two modes; the JAX files
# (outLogs/<set>/<op>.jsonl, c<cluster>/<op>.log) are never written.
set -e
set_name=$1; op=$2; cluster=${3:-1}
case "$set_name" in
  A) max_level=28; alpha=28; n=32768 ;;
  B) max_level=45; alpha=15; n=65536 ;;
  C) max_level=24; alpha=6; n=65536 ;;
  D) max_level=26; alpha=9; n=65536 ;;
  M) max_level=28; alpha=28; n=65536 ;;
  *) echo "usage: $0 <A|B|C|D|M> <op> [cluster]" >&2; exit 1 ;;
esac
case "$op" in
  hmult|hadd|hrotate|pmult|padd) ;;
  *) echo "usage: $0 <set> <hmult|hadd|hrotate|pmult|padd> [cluster]" >&2
     exit 1 ;;
esac
root=$(cd "$(dirname "$0")/.." && pwd)
if [ "$cluster" -le 1 ]; then
  exec python3 "$root/scripts/sweep_torch.py" --sets "$set_name" \
    --ops "$op" --levels all --out "$root/outLogs"
fi
cfg="$root/configs/n16.cfg"
[ "$n" = 32768 ] && cfg="$root/configs/n15.cfg"
outdir="$root/outLogs/$set_name/c$cluster"
mkdir -p "$outdir"
set -o pipefail
levels=$(printf '%s\n' "$max_level" $((3*max_level/4)) $((max_level/2)) \
  $((max_level/4)) 2 | sort -runk1)
case "$op" in
  hmult|hrotate)
    disps="limb coeff"
    [ "$cluster" -ge 4 ] && [ $((cluster % 2)) -eq 0 ] && \
      disps="$disps hybrid"
    ;;
  *) disps="auto" ;;
esac
# Every level and dispatch runs even after one fails; the exit status is
# 1 if any run failed, and the log keeps the failing run's output.
failed=0
for lvl in $levels; do
  [ "$lvl" -lt 2 ] && continue
  for disp in $disps; do
    PYTHONPATH="$root" python3 -m homulator_tpu_torch run "$cfg" "$op" \
      "$max_level" "$lvl" "$alpha" "$cluster" --device cuda --iters 1 \
      --verify --dispatch "$disp" 2>&1 | tee -a "$outdir/${op}_torch.log" \
      || { failed=1; echo "# FAILED: $op $max_level $lvl $alpha $cluster" \
             "--dispatch $disp" | tee -a "$outdir/${op}_torch.log"; }
  done
done
exit $failed
