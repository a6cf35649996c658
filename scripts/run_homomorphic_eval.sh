#!/usr/bin/env bash
# FHE evaluation launcher with per-model presets — parity with the
# reference run_homomorphic_eval.sh (rounding 6 for CIFAR / 7 for ImageNet,
# n_bits 5, p_error 0.01: reference run_homomorphic_eval.sh:17-61).
set -euo pipefail

MODEL=${MODEL:-ResNet20qat}
DATASET=${DATASET:-cifar10}
DATASET_PATH=${DATASET_PATH:-./cifardataset}
CHECKPOINT=${CHECKPOINT:-}
FHE_MODE=${FHE_MODE:-simulate}       # simulate | execute
TEST_SUBSET=${TEST_SUBSET:-100}

case "$MODEL" in
  ResNet20*)
    FILTER_SIZE=${FILTER_SIZE:-4}
    CHANNELS=${CHANNELS:-24}
    IMAGE_SIZE_DCT=${IMAGE_SIZE_DCT:-16}
    BIT_WIDTH=${BIT_WIDTH:-4}
    ROUNDING=${ROUNDING:-6}
    ;;
  ResNet18*)
    FILTER_SIZE=${FILTER_SIZE:-8}
    CHANNELS=${CHANNELS:-64}
    IMAGE_SIZE_DCT=${IMAGE_SIZE_DCT:-56}
    if [ "$DATASET" = "ImageNet" ]; then
      BIT_WIDTH=${BIT_WIDTH:-5}
      ROUNDING=${ROUNDING:-7}
    else
      BIT_WIDTH=${BIT_WIDTH:-4}
      ROUNDING=${ROUNDING:-6}
    fi
    ;;
esac

exec python -m dct_cryptonets.homomorphic_eval \
  --dataset "$DATASET" \
  --dataset_path "$DATASET_PATH" \
  --model "$MODEL" \
  --dct_status \
  --channels "$CHANNELS" \
  --filter_size "$FILTER_SIZE" \
  --image_size_dct "$IMAGE_SIZE_DCT" \
  --bit_width "$BIT_WIDTH" \
  --rounding_threshold_bits "$ROUNDING" \
  --n_bits 5 \
  --p_error 0.01 \
  --fhe_mode "$FHE_MODE" \
  --test_subset "$TEST_SUBSET" \
  ${CHECKPOINT:+--checkpoint_path "$CHECKPOINT"} \
  "$@"
