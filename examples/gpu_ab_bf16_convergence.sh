#!/bin/sh
# bf16-vs-f32 convergence A/B of the PyTorch port on synthetic YCB: the
# counterpart of examples/ab_bf16_convergence.sh. One seed-identical
# dataset, two cli.train runs differing ONLY in --bf16; then the per-epoch
# test avg_dis curves of the two metrics.jsonl files compared (mean and max
# |delta| over the epochs both ran, and each run's best epoch), printed as
# one JSON object with the device, the card's name and power limit.
#
#   sh examples/gpu_ab_bf16_convergence.sh [ROOT] [EPOCHS] [cli.train flags]
#
# Runs on the card; it raises before generating anything when there is
# none, unless the cli.train flags hold --device cpu.
set -e
REPO=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
ROOT=${1:-$(mktemp -d "${TMPDIR:-/tmp}/ab_bf16.XXXXXX")}
EPOCHS=${2:-25}
if [ $# -ge 2 ]; then shift 2; else shift $#; fi
mkdir -p "$ROOT"
python - "$ROOT" "$@" <<'EOF'
import argparse
import os
import sys
from densefusion_tpu_torch.data.synthetic import generate_ycb_style_dataset
from densefusion_tpu_torch.device import resolve_device
p = argparse.ArgumentParser()
p.add_argument("--device", default=None)
resolve_device(p.parse_known_args(sys.argv[2:])[0].device)
root = os.path.join(sys.argv[1], "dataset")
if not os.path.isdir(os.path.join(root, "dataset_config")):
    generate_ycb_style_dataset(root, n_classes=5, n_real=320, n_syn=64,
                               n_test=32, seed=3,
                               posecnn_dir=os.path.join(sys.argv[1], "posecnn"))
    print("dataset generated ->", root)
EOF
for MODE in f32 bf16; do
  EXTRA=""
  [ "$MODE" = bf16 ] && EXTRA="--bf16"
  echo "=== $MODE run ==="
  python -m densefusion_tpu_torch.cli.train --dataset ycb \
    --dataset_root "$ROOT/dataset" --batch_size 8 --workers 4 \
    --nepoch "$EPOCHS" --crop_size 192 --seed 3 --num_objects 5 \
    --out_dir "$ROOT/out_$MODE" --log_dir "$ROOT/logs_$MODE" $EXTRA "$@"
done
python - "$ROOT" "$@" <<'EOF'
import argparse
import json
import os
import sys
from densefusion_tpu_torch.device import resolve_device, run_record
p = argparse.ArgumentParser()
p.add_argument("--device", default=None)
dev = resolve_device(p.parse_known_args(sys.argv[2:])[0].device)
curves = {}
for mode in ("f32", "bf16"):
    with open(os.path.join(sys.argv[1], f"logs_{mode}", "ycb",
                           "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    curves[mode] = {r["epoch"]: r["avg_dis"] for r in rows
                    if r["kind"] == "test_epoch"}
epochs = sorted(set(curves["f32"]) & set(curves["bf16"]))
deltas = [abs(curves["f32"][e] - curves["bf16"][e]) for e in epochs]
best = {mode: min(c.items(), key=lambda kv: kv[1])
        for mode, c in curves.items()}
print(json.dumps({
    "epochs_compared": len(epochs),
    "mean_abs_delta_m": sum(deltas) / len(deltas),
    "max_abs_delta_m": max(deltas),
    "best_epoch": {m: {"epoch": e, "avg_dis": d}
                   for m, (e, d) in best.items()},
    "best_avg_dis_delta_m": abs(best["f32"][1] - best["bf16"][1]),
    "test_avg_dis": {m: [c[e] for e in sorted(c)]
                     for m, c in curves.items()},
    **run_record(dev, "float32 against bfloat16")}))
EOF
echo AB DONE
