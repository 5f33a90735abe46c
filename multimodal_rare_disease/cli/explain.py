"""Explainability CLI (parity: notebooks/explainability.ipynb as a
command — Grad-CAM overlay, text-token attention, cross-modal attention
for one sample or a per-class batch)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


from multimodal_rare_disease.cli._common import (
    add_platform_arg,
    configure_platform,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Grad-CAM + attention explainability")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", default=None)
    parser.add_argument("--text", default=None)
    parser.add_argument("--outdir", default="results/explain")
    parser.add_argument("--batch", action="store_true",
                        help="run one sample per syndrome from the corpus")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    from multimodal_rare_disease.cli._common import setup_logging

    setup_logging(verbose=False)

    from multimodal_rare_disease.data.images import load_image_uint8
    from multimodal_rare_disease.explain import (
        GradCAM,
        cross_modal_attention_summary,
        overlay_heatmap,
        text_token_attention,
    )
    from multimodal_rare_disease.explain.attention import (
        plot_cross_modal_attention,
        plot_text_attention,
    )
    from multimodal_rare_disease.inference import load_predictor

    predictor = load_predictor(args.checkpoint)
    cfg = predictor.cfg
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    samples = []
    if args.batch:
        from collections import defaultdict

        from multimodal_rare_disease.config import find_image_dir
        from multimodal_rare_disease.data.clinical_text import (
            load_clinical_descriptions,
        )
        from multimodal_rare_disease.data.images import scan_image_corpus

        desc = load_clinical_descriptions(cfg)
        image_dir = find_image_dir(cfg)
        by_class = defaultdict(list)
        for s in scan_image_corpus(image_dir):
            by_class[s.syndrome].append(s)
        for syndrome, group in sorted(by_class.items()):
            samples.append((group[0].path,
                            desc.get(syndrome, {}).get("clinical_description",
                                                       syndrome),
                            syndrome))
    else:
        if not args.image:
            parser.error("--image required (or use --batch)")
        samples.append((args.image, args.text or "", "sample"))

    gc = GradCAM(cfg, predictor.model, predictor.params,
                 predictor.batch_stats, mode=predictor.mode)

    index = []
    for img_path, text, name in samples:
        tag = name.replace(" ", "_")
        img = load_image_uint8(img_path, 256)

        if predictor.mode != "image_only" and text:
            ids, mask, _ = predictor.tokenizer.encode(
                text, cfg.data.max_text_length)
            ids_b, mask_b = ids[None], mask[None]
        else:
            ids_b = np.zeros((1, 1), np.int32)
            mask_b = np.ones((1, 1), np.int32)

        cam, logits = gc(img[None], ids_b, mask_b)
        pred_class = int(np.argmax(logits[0]))
        overlay = overlay_heatmap(img, cam[0])
        from PIL import Image

        Image.fromarray(overlay).save(outdir / f"{tag}_gradcam.png")

        entry = {"sample": name, "image": str(img_path),
                 "predicted_class": pred_class,
                 "predicted_syndrome": predictor.class_names[pred_class],
                 "gradcam": f"{tag}_gradcam.png"}

        if predictor.mode == "multimodal" and text:
            pairs = text_token_attention(
                cfg, predictor.model, predictor.params,
                predictor.batch_stats, predictor.tokenizer, text)
            plot_text_attention(pairs, outdir / f"{tag}_text_attention.png")
            entry["top_tokens"] = sorted(pairs, key=lambda p: -p[1])[:8]

            import jax.numpy as jnp

            from multimodal_rare_disease.ops.preprocess import (
                eval_preprocess,
            )

            # attention must be computed for the ACTUAL sample image —
            # a blank image would render cross-modal attention for the
            # wrong input (notebook cells 7/9 use the same sample)
            x = eval_preprocess(jnp.asarray(img[None]), cfg)
            out = predictor.model.apply(
                {"params": predictor.params,
                 "batch_stats": predictor.batch_stats},
                x, jnp.asarray(ids_b), jnp.asarray(mask_b),
                train=False, return_attention=True)
            summary = cross_modal_attention_summary(out["attention_info"])
            plot_cross_modal_attention(summary,
                                       outdir / f"{tag}_cross_modal.png")
            entry["cross_modal"] = f"{tag}_cross_modal.png"

        index.append(entry)
        print(f"[{name}] predicted {entry['predicted_syndrome']} -> "
              f"{tag}_gradcam.png")

    (outdir / "index.json").write_text(json.dumps(index, indent=2,
                                                  default=float))
    print(f"wrote {len(index)} sample(s) to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
