#!/usr/bin/env bash
# The port's flagship G-LIS run on images, on one NVIDIA GPU:
#
#   1. generate demo20k with gea_torch.cli.make_demo_data (the command of
#      data/demo20k/MANIFEST.json) and compare its MANIFEST.json with the
#      committed one (library versions, dump hash, the 17 spot hashes);
#   2. train flagship G-LIS on it as gea's r4_flag80 run was trained
#      (docs/RESULTS.md, "Flagship re-run"): 80x80, code 256, 3 LIS modules,
#      weight norm, nf 64 / cap 512, bf16, batch 128, BCE, seed 42,
#      --data_cache --host_resize --fid_interval 500;
#   3. score the best snapshot as gea's run was scored (1,024 samples):
#      compute_fid --step -1 --second_opinion, eval_stages --step -1, and
#      sample --step -1 --d_filter --save_gif.
#
#   bash scripts/torch_demo20k_run.sh [NITER] [OUT]   # default 5000 steps
#
# Data, checkpoints and grids go to runs/torch_demo20k/ (not committed); the
# logs, the JSON results, fid.jsonl, best.json and the sample grids of the
# best snapshot go to OUT (default runs/torch_demo20k_results/).
set -euo pipefail
NITER=${1:-5000}
ROOT=runs/torch_demo20k
DATA=$ROOT/demo20k
RUN=$ROOT/glis
OUT=${2:-runs/torch_demo20k_results}
rm -rf "$ROOT" "$OUT"
mkdir -p "$ROOT" "$OUT"

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' \
  | tee "$OUT/versions.txt"

t0=$(date +%s.%N)
python -m gea_torch.cli.make_demo_data --out "$DATA" --count 20000 --size 200 --seed 0 \
  --quality 92 --style diverse 2>&1 | tee "$OUT/make_demo_data.log"
t1=$(date +%s.%N)
python - "$DATA/MANIFEST.json" data/demo20k/MANIFEST.json "$t0" "$t1" <<'EOF' | tee "$OUT/manifest_check.json"
import json, sys
got, want = (json.load(open(p)) for p in sys.argv[1:3])
spot = {k: got["sha256_spot_check"].get(k) == v for k, v in want["sha256_spot_check"].items()}
print(json.dumps({
    "seconds": float(sys.argv[4]) - float(sys.argv[3]),
    "versions": got["versions"], "manifest_versions": want["versions"],
    "same_pillow_libjpeg": all(got["versions"][k] == want["versions"][k]
                               for k in ("pillow", "libjpeg")),
    "count": got["count"], "sha256_dump_equal": got["sha256_dump"] == want["sha256_dump"],
    "spot_equal": sum(spot.values()), "spot_total": len(spot),
    "spot_differ": sorted(k for k, ok in spot.items() if not ok)}))
EOF

python -m gea_torch.cli.train_glis --dataset folder --dataroot "$DATA" --image_size 80 \
  --crop_size 160 --code_size 256 --r_iterations 3 --norm weight --num_features 64 \
  --max_features 512 --dtype bfloat16 --batch_size 128 --gan_loss bce --seed 42 \
  --data_cache true --host_resize true --fid_interval 500 --niter "$NITER" \
  --save_interval 500 --vis_interval 500 --log_interval 100 --save_path "$RUN" \
  2>&1 | tee "$OUT/train_glis.log"
cp "$RUN/fid.jsonl" "$RUN/best.json" "$RUN/config.json" "$OUT/"

python -m gea_torch.cli.compute_fid --load_path "$RUN" --dataset folder --dataroot "$DATA" \
  --num_samples 1024 --step -1 --second_opinion --out "$OUT/compute_fid_best.json" \
  2>&1 | tee "$OUT/compute_fid.log"
python -m gea_torch.cli.eval_stages --load_path "$RUN" --num_samples 1024 --step -1 \
  --out "$OUT/eval_stages_best.json" 2>&1 | tee "$OUT/eval_stages.log"
python -m gea_torch.cli.sample --load_path "$RUN" --step -1 --d_filter --save_gif true \
  --save_path_samples "$OUT/samples" 2>&1 | tee "$OUT/sample.log"
python -m gea_torch.cli.info --load_path "$RUN" > "$OUT/info.json"
# The final stage's grid as a JPEG small enough for docs/images/.
python -c 'import sys; from PIL import Image; Image.open(sys.argv[1]).convert("RGB").save(sys.argv[2], quality=85)' \
  "$OUT/samples/samples_00000000_stage3.png" "$OUT/best_dfilter_stage3.jpg"
echo "torch_demo20k_run: done"
