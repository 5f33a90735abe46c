"""Offline augmentation CLI (parity: `scripts/generate_augmented_data.py`)."""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Expand an image corpus with deterministic offline "
                    "augmentations (50 -> 550 style)")
    parser.add_argument("--src", required=True, help="source corpus dir")
    parser.add_argument("--out", required=True,
                        help="output dir (images_augmented layout)")
    parser.add_argument("--num", type=int, default=10,
                        help="augmented copies per image")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from multimodal_rare_disease.data.offline_augment import (
        generate_augmented_dataset,
    )

    counts = generate_augmented_dataset(args.src, args.out,
                                        augmentations_per_image=args.num,
                                        seed=args.seed)
    print(f"wrote {counts['original']} originals + "
          f"{counts['augmented']} augmented images to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
