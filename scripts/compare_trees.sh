#!/bin/sh
# Warm proves, spans and per-kernel device time of two checkouts of the
# repo on one card, in turns A, B, B, A, so that the card and its power
# limit are the same for both:
#
#   scripts/compare_trees.sh A_DIR B_DIR OUT_DIR [spans arguments ...]
#
# Each turn runs `python3 -m multistark_tpu_torch.spans` in its tree (which
# builds that tree's kernels) with this checkout's spans.py copied into the
# tree's package, and writes its output to OUT_DIR/<turn>_<A|B>.txt.
# Needs a CUDA device.
set -eu
here=$(cd "$(dirname "$0")/.." && pwd)
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
shift 3
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
turn=0
for tree in A B B A; do
    turn=$((turn + 1))
    if [ "$tree" = A ]; then dir=$a; else dir=$b; fi
    if [ "$dir/multistark_tpu_torch/spans.py" -ef "$here/multistark_tpu_torch/spans.py" ]; then :; else
        cp "$here/multistark_tpu_torch/spans.py" "$dir/multistark_tpu_torch/spans.py"
    fi
    echo "turn $turn: tree $tree ($dir)"
    (cd "$dir" && python3 -m multistark_tpu_torch.spans "$@") > "$out/${turn}_$tree.txt" 2>&1
    grep -E "warm prove, |device busy|profiled prove, (K[0-9]+ |PyTorch ops)" \
        "$out/${turn}_$tree.txt"
done
