"""Inference CLI (parity: `src/predict.py:360-408` + root `predict.py`).

Examples:
  python -m multimodal_rare_disease.cli.predict \
      --checkpoint checkpoints/multimodal_best \
      --image face.png --text "Patient presents with ..." --output out.json
  python -m multimodal_rare_disease.cli.predict --demo \
      --checkpoint checkpoints/multimodal_best
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


from multimodal_rare_disease.cli._common import (
    add_platform_arg,
    configure_platform,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Rare-disease prediction")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", default=None)
    parser.add_argument("--text", default=None)
    parser.add_argument("--text-file", default=None)
    parser.add_argument("--mode", default=None,
                        choices=[None, "multimodal", "image_only", "text_only"])
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--output", default=None, help="write JSON here")
    parser.add_argument("--report", action="store_true",
                        help="print the clinical report rendering")
    parser.add_argument("--embeddings", action="store_true")
    parser.add_argument("--demo", action="store_true",
                        help="predict on one sample per syndrome from the corpus")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    from multimodal_rare_disease.cli._common import setup_logging

    setup_logging(verbose=False)

    from multimodal_rare_disease.inference import load_predictor

    predictor = load_predictor(args.checkpoint, mode=args.mode)

    if args.demo:
        return _demo(predictor, args.top_k)

    text = args.text
    if args.text_file:
        text = Path(args.text_file).read_text(encoding="utf-8").strip()

    if predictor.mode != "text_only" and not args.image:
        parser.error(f"--image is required for mode {predictor.mode}")
    if predictor.mode != "image_only" and not text:
        parser.error(f"--text or --text-file is required for mode "
                     f"{predictor.mode}")

    result = predictor.predict(image=args.image, text=text, top_k=args.top_k,
                               return_embeddings=args.embeddings)

    if args.report:
        print(predictor.format_report(result))
    else:
        print(json.dumps(result, indent=2))
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=2),
                                     encoding="utf-8")
        print(f"saved to {args.output}", file=sys.stderr)
    return 0


def _demo(predictor, top_k: int) -> int:
    """Per-syndrome sample predictions with accuracy tally (parity:
    demo_multimodal_predict.py)."""
    from collections import defaultdict

    from multimodal_rare_disease.config import get_config, find_image_dir
    from multimodal_rare_disease.data.clinical_text import (
        load_clinical_descriptions,
    )
    from multimodal_rare_disease.data.images import scan_image_corpus

    cfg = get_config()
    image_dir = find_image_dir(cfg)
    if image_dir is None:
        print("no image corpus found for --demo")
        return 1
    samples = scan_image_corpus(image_dir)
    desc = load_clinical_descriptions(cfg)
    by_class = defaultdict(list)
    for s in samples:
        by_class[s.syndrome].append(s)

    correct = 0
    total = 0
    for syndrome, group in sorted(by_class.items()):
        s = group[0]
        text = desc.get(syndrome, {}).get("clinical_description", syndrome)
        result = predictor.predict(
            image=s.path,
            text=text if predictor.mode != "image_only" else None,
            top_k=top_k)
        top = result["top_prediction"]
        ok = top["syndrome"] == syndrome
        correct += ok
        total += 1
        mark = "OK " if ok else "MISS"
        print(f"[{mark}] {syndrome:<34} -> {top['syndrome']:<34} "
              f"({top['probability_percent']:.1f}%)")
    print(f"\ndemo accuracy: {correct}/{total} = {correct / total:.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
