"""Evaluation CLI (parity: `src/evaluate.py` + `evaluate_multimodal.py` —
except this one actually runs by default, unlike the reference's stub
`main()`, and evaluates a held-out split rather than the training set).
"""

from __future__ import annotations

import argparse
import json


from multimodal_rare_disease.cli._common import (
    add_platform_arg,
    configure_platform,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate a trained model")
    parser.add_argument("--checkpoint", required=True, action="append",
                        help="checkpoint dir; repeat to compare models")
    parser.add_argument("--mode", default=None, action="append",
                        help="mode per checkpoint (default: from meta)")
    parser.add_argument("--image-dir", default=None)
    parser.add_argument("--results-dir", default=None)
    parser.add_argument("--split", default="val", choices=["val", "train", "all"])
    parser.add_argument("--stats", action="store_true",
                        help="run chi-square/McNemar after evaluating "
                             "multiple checkpoints")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    from multimodal_rare_disease.cli._common import setup_logging

    setup_logging()

    from multimodal_rare_disease.config import Config
    from multimodal_rare_disease.evaluation import Evaluator, compare_models
    from multimodal_rare_disease.inference import load_predictor
    from multimodal_rare_disease.train.pipeline import DataPipeline

    metrics_by_mode = {}
    results_dir = args.results_dir
    for i, ckpt in enumerate(args.checkpoint):
        mode = args.mode[i] if args.mode and i < len(args.mode) else None
        predictor = load_predictor(ckpt, mode=mode)
        cfg = predictor.cfg
        if results_dir is None:
            results_dir = cfg.evaluation.results_dir
        pipeline = DataPipeline(cfg, mode=predictor.mode,
                                image_dir=args.image_dir,
                                tokenizer=predictor.tokenizer)
        if args.split == "val":
            batches = pipeline.val_batches()
        elif args.split == "train":
            batches = pipeline.train_batches()
        else:
            def _all(p=pipeline):
                yield from p.val_batches()
                yield from p.train_batches()
            batches = _all()

        ev = Evaluator(cfg, predictor.model, predictor.params,
                       predictor.batch_stats, mode=predictor.mode)
        collected = ev.collect_predictions(batches)
        metrics = ev.save_results(collected, results_dir)
        metrics_by_mode[predictor.mode] = metrics
        print(f"[{predictor.mode}] accuracy={metrics['accuracy']:.4f} "
              f"f1_macro={metrics['f1_macro']:.4f} "
              f"n={metrics['num_samples']}")

    if len(metrics_by_mode) > 1:
        print()
        print(compare_models(metrics_by_mode, results_dir))

    if args.stats:
        from multimodal_rare_disease.evaluation.stats import (
            hypothesis_conclusion,
            run_statistical_validation,
        )

        results = run_statistical_validation(results_dir)
        if results is None:
            print("stats: need >=2 modes' prediction dumps")
        else:
            print(hypothesis_conclusion(results))

    print(json.dumps({m: {"accuracy": v["accuracy"],
                          "f1_macro": v["f1_macro"]}
                      for m, v in metrics_by_mode.items()}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
