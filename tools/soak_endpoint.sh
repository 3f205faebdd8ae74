#!/bin/bash
# Reproduce the endpoint-stability measurements behind docs/DESIGN.md §3
# and the README "endpoint-quality recipe" (CPU backend; ~45 min per run
# on one core).
#
# Variants over the same 1600-step verify-scene recipe (seed 0):
#   base    constant-lr tail oscillation (excursions 5e-5 <-> 5e-3+)
#   cosine  lr decay alone: stable until the late grid-culling event
#   f0      cosine to lr floor 0: excursion STILL fires with param_norm
#           frozen -> proves the grid, not the optimizer, drives it
#   pinned  cosine + --occ_freeze_grid_after 512: no excursion, ends
#           ~6e-5, renders 49-50 dB across render keys
set -ex
cd "$(dirname "$0")/.."
SCENE=${1:-/tmp/verify_scene}
ENVP="env JAX_PLATFORMS=cpu"
$ENVP python -c "
import sys; sys.path.insert(0, '.')
from tests.synthetic_scene import write_dataset
write_dataset('$SCENE', num_views=8, resolution=32)"

COMMON="--seed 0 --lr 2e-3 --batch_size 512 --occupancy --occ_candidates 32 \
  --occ_samples 12 --occ_grid 32 --occ_train_budget auto \
  --occ_train_budget_start 300 --steps_per_dispatch 8 --ema 0.99 \
  --coarse_samples 8 --fine_samples 8 --steps 1600"

$ENVP python -m learn_nerf_tpu.scripts.train_nerf $COMMON \
  --save_path /tmp/soak_base.pkl "$SCENE" | tail -20
$ENVP python -m learn_nerf_tpu.scripts.train_nerf $COMMON --lr_schedule cosine \
  --save_path /tmp/soak_cosine.pkl "$SCENE" | tail -20
$ENVP python -m learn_nerf_tpu.scripts.train_nerf $COMMON --lr_schedule cosine \
  --lr_final_frac 0.0 \
  --save_path /tmp/soak_f0.pkl "$SCENE" | tail -20
$ENVP python -m learn_nerf_tpu.scripts.train_nerf $COMMON --lr_schedule cosine \
  --occ_freeze_grid_after 512 \
  --save_path /tmp/soak_pinned.pkl "$SCENE" | tail -20

# Render each endpoint at 3 keys; the pinned variant should sit at
# 49-50 dB while the others scatter (see DESIGN §3 for the expected
# numbers and the param_norm-frozen diagnostic on the f0 log).
for v in base cosine f0 pinned; do
  for k in 0 1 2; do
    $ENVP python -m learn_nerf_tpu.scripts.render_nerf --seed $k --batch_size 1024 \
      --occupancy --occ_candidates 32 --occ_samples 12 --occ_grid 32 \
      --width 32 --height 32 --model_path /tmp/soak_$v.pkl \
      "$SCENE/metadata.json" "$SCENE/0000.json" /tmp/soak_${v}_$k.png
    $ENVP python -c "
from PIL import Image; import numpy as np
p = np.asarray(Image.open('/tmp/soak_${v}_$k.png')).astype(np.float32)
g = np.asarray(Image.open('$SCENE/0000.png')).astype(np.float32)
print('$v key $k PSNR', 10*np.log10(255**2/((p-g)**2).mean()))"
  done
done
