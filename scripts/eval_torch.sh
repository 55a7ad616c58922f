#!/usr/bin/env bash
# Evaluation presets per dataset for the PyTorch port (the flags of
# scripts/eval.sh, letter for letter): depth maps and fusion on the card
# (add --device cpu to run the kernels' plain versions on the CPU).
#   bash scripts/eval_torch.sh run_eth3d INPUT OUTPUT SCAN_LIST [flags...]
CKPT="checkpoints/params_000007.msgpack"

run_dtu() {
  python -m patchmatchnet_torch eval --input_folder "$1" --output_folder "$2" \
      --checkpoint_path "$CKPT" --scan_list lists/dtu/test.txt \
      --num_views 5 --image_max_dim 1600 --geo_mask_thres 3 --photo_thres 0.8 "${@:3}"
}

run_eth3d() {
  python -m patchmatchnet_torch eval --input_folder "$1" --output_folder "$2" \
      --checkpoint_path "$CKPT" --scan_list "$3" \
      --num_views 7 --image_max_dim 2688 --geo_mask_thres 2 --photo_thres 0.6 "${@:4}"
}

run_tanks() {
  python -m patchmatchnet_torch eval --input_folder "$1" --output_folder "$2" \
      --checkpoint_path "$CKPT" --scan_list "$3" \
      --num_views 7 --image_max_dim 2048 --geo_mask_thres 5 --photo_thres 0.8 "${@:4}"
}

run_custom() {
  python -m patchmatchnet_torch eval --input_folder "$1" --output_folder "$2" \
      --checkpoint_path "$CKPT" --num_views 10 --image_max_dim 2048 \
      --geo_mask_thres 5 --photo_thres 0.8 "${@:3}"
}

"$@"
