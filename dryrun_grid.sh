#!/bin/bash
# The port's production-mesh dry-run grid: launch/dryrun.py --mesh pod1 and pod2
# over every arch and shape (80 records, host traces on meta tensors), one
# process per (mesh, arch, shape) cell, 8 at a time, the longest cells first;
# then each mesh's whole run over the records (which prints every cell and
# 'failures: N'), then roofline/reanalyze.py on a copy, checked to reproduce
# every record.  From the root of a checkout:
#
#     bash dryrun_grid.sh [OUT]
#
# Records under OUT/{pod1,pod2}/ (default OUT: results/dryrun_grid), a log
# per cell under OUT/logs/.
export PYTHONPATH=src
out=${1:-results/dryrun_grid}
rm -rf $out; mkdir -p $out/pod1 $out/pod2 $out/logs
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
echo "host: $(nproc) cores, $(grep -m1 'model name' /proc/cpuinfo)"
start=$(date +%s)
archs=$(python -c 'from repro_torch.configs import list_archs; print(*list_archs())')
for s in train_4k prefill_32k decode_32k long_500k; do
  for a in xlstm-1.3b $archs; do for m in pod1 pod2; do echo "$m $a $s"; done; done
done | awk '!seen[$0]++' | xargs -P 8 -L 1 sh -c \
  't0=$(date +%s); python -m repro_torch.launch.dryrun --mesh $0 --arch $1 --shape $2 --out '$out'/$0 > '$out'/logs/$0_$1_$2.log 2>&1; echo "cell $0 $1 $2 rc=$? $(( $(date +%s) - t0 )) s"'
echo "cells done in $(( $(date +%s) - start )) s"
for m in pod1 pod2; do
  python -m repro_torch.launch.dryrun --mesh $m --out $out/$m > $out/$m.log 2>&1
  echo "$m rc=$? records=$(ls $out/$m/*.json | wc -l)"; grep -E "failures|SKIP|FAIL" $out/$m.log
  cp -r $out/$m $out/${m}_reanalyzed
  python -m repro_torch.roofline.reanalyze --dir $out/${m}_reanalyzed > $out/${m}_reanalyze.log 2>&1
  python - "$out/$m" "$out/${m}_reanalyzed" <<'PY'
import json, sys
from pathlib import Path
a, b = Path(sys.argv[1]), Path(sys.argv[2])
diff = [f.name for f in sorted(a.glob("*.json")) if json.loads(f.read_text()) != json.loads((b / f.name).read_text())]
print(f"reanalyze reproduces {len(list(a.glob('*.json'))) - len(diff)} of {len(list(a.glob('*.json')))} records; differs: {diff}")
PY
done
echo "grid wall $(( $(date +%s) - start )) s"
