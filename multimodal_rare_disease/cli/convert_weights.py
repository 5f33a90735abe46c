"""Offline pretrained-weight conversion CLI.

Converts user-supplied torch/HF checkpoint files (no network egress
assumed) into this framework's checkpoint format (utils/checkpoint.py):

  # torchvision resnet50 state_dict (.pt/.pth)
  python -m multimodal_rare_disease.cli.convert_weights \
      --backbone resnet50.pth --out checkpoints/imagenet_backbone

  # HF BioBERT directory (pytorch_model.bin + vocab.txt)
  python -m multimodal_rare_disease.cli.convert_weights \
      --hf-bert /path/to/biobert --out checkpoints/biobert
"""

from __future__ import annotations

import argparse
from pathlib import Path


from multimodal_rare_disease.cli._common import (
    add_platform_arg,
    configure_platform,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Convert torch/HF weights")
    parser.add_argument("--backbone", default=None,
                        help="torchvision resnet50 state_dict file")
    parser.add_argument("--hf-bert", default=None,
                        help="HF BERT model dir or state_dict file")
    parser.add_argument("--out", required=True, help="output checkpoint dir")
    parser.add_argument("--num-layers", type=int, default=12)
    parser.add_argument("--num-heads", type=int, default=12)
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    if not args.backbone and not args.hf_bert:
        parser.error("provide --backbone and/or --hf-bert")

    from multimodal_rare_disease.models.convert import (
        convert_hf_bert,
        convert_torchvision_resnet50,
        load_torch_state_dict,
    )
    from multimodal_rare_disease.utils.checkpoint import save_checkpoint

    params, stats, meta = {}, {}, {"converted": []}

    if args.backbone:
        sd = load_torch_state_dict(args.backbone)
        p, s = convert_torchvision_resnet50(sd)
        params["backbone"] = p
        stats["backbone"] = s
        meta["converted"].append(f"resnet50:{args.backbone}")
        print(f"converted ResNet50 backbone from {args.backbone}")

    if args.hf_bert:
        src = Path(args.hf_bert)
        sd_file = src
        vocab_file = None
        if src.is_dir():
            for cand in ("pytorch_model.bin", "model.pt", "model.safetensors"):
                if (src / cand).exists():
                    sd_file = src / cand
                    break
            if (src / "vocab.txt").exists():
                vocab_file = src / "vocab.txt"
        if str(sd_file).endswith(".safetensors"):
            from safetensors.torch import load_file  # optional dep

            sd = load_file(str(sd_file))
        else:
            sd = load_torch_state_dict(str(sd_file))
        params["bert"] = convert_hf_bert(sd, num_layers=args.num_layers,
                                         num_heads=args.num_heads)
        meta["converted"].append(f"bert:{sd_file}")
        if vocab_file:
            meta["vocab"] = [line.rstrip("\n") for line in
                             open(vocab_file, encoding="utf-8") if line.strip()]
            print(f"embedded vocab ({len(meta['vocab'])} tokens)")
        print(f"converted BERT encoder from {sd_file}")

    save_checkpoint(args.out, params, stats, step=0, meta=meta)
    print(f"wrote converted weights to {args.out}")
    print("Load via models/convert.py::convert_backbone_into / "
          "convert_bert_into to graft into a model checkpoint.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
