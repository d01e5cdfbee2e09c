#!/bin/bash
# The dry run's sweep over every (arch, cell) of all_cells() on both
# production meshes, in four processes split by architecture, merged into
# one results file (the CLI resumes a file; each process writes its own).
#
# Run:  bash tools/dryrun_sweep.sh [OUT_DIR]     (default results/)
# Writes OUT_DIR/dryrun_torch.json and one .json and .log a process under
# OUT_DIR/sweep/; prints the wall time and the cells that failed.
set -u
cd "$(dirname "$0")/.."
out=${1:-results}
mkdir -p "$out/sweep"
t0=$(date +%s)
for group in "moonshot_v1_16b_a3b granite_3_2b" \
             "qwen2_moe_a2_7b yi_6b gemma3_1b" \
             "qwen2_vl_7b h2o_danube_1_8b whisper_tiny" \
             "recurrentgemma_2b mamba2_780m"; do
  set -- $group
  (for arch in $group; do
     PYTHONPATH=src python3 -m repro_torch.launch.dryrun --arch "$arch" \
       --mesh both --out "$out/sweep/$1.json"
   done > "$out/sweep/$1.log" 2>&1) &
done
wait
echo "sweep wall $(( $(date +%s) - t0 )) s"
OUT="$out" python3 - <<'PY'
import glob, json, os
out = os.environ["OUT"]
results = {}
for path in sorted(glob.glob(os.path.join(out, "sweep", "*.json"))):
    with open(path) as f:
        results.update(json.load(f))
with open(os.path.join(out, "dryrun_torch.json"), "w") as f:
    json.dump(results, f, indent=1)
print(len(results), "cells,", sum(r["ok"] for r in results.values()), "ok")
for key, rec in sorted(results.items()):
    if not rec["ok"]:
        print("FAIL", key, rec["error"][:300])
PY
