#!/bin/bash
# Regenerate the benchmark datasets under runs/ (gitignored, so a fresh
# checkout lacks them; the recipe is checked in so it can never be lost).
#
#   runs/scene_train        compound STL scene, 400x400, 195 views, seed 0
#   runs/scene_test         same scene, 8 held-out views, seed 1
#   runs/scene_shiny_train  specular variant (Blinn-Phong 0.5), 400x400
#   runs/scene_shiny_test   8 held-out shiny views, seed 1
#
# Deterministic end to end: make_scene_stl.py is seed-free geometry and
# simple_dataset takes -seed, so reruns are bit-identical.
set -ex
cd "$(dirname "$0")/.."
make -C tools/cpp
mkdir -p runs
env JAX_PLATFORMS=cpu PYTHONPATH=. \
  python tools/make_scene_stl.py runs/compound.stl

gen() { # out_dir images seed extra...
  local out="$1" images="$2" seed="$3"; shift 3
  if [ ! -f "$out/metadata.json" ]; then
    rm -rf "$out"
    bin/simple_dataset -resolution 400 -images "$images" -seed "$seed" \
      "$@" runs/compound.stl "$out"
  fi
}
gen runs/scene_train 195 0
gen runs/scene_test 8 1
gen runs/scene_shiny_train 195 0 -specular 0.5
gen runs/scene_shiny_test 8 1 -specular 0.5
echo SCENES OK
