"""Statistical validation CLI (parity: `src/chi_square_test.py:421-486`,
including --demo with the 85/75/70% synthetic oracle — minus the
reference's scipy.stats.mcnemar ImportError)."""

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
        description="Chi-square / McNemar / bootstrap validation of "
                    "multimodal vs unimodal predictions")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--n-bootstrap", type=int, default=1000)
    parser.add_argument("--demo", action="store_true",
                        help="run on synthetic predictions at known "
                             "accuracies (multimodal 85%%, image 75%%, "
                             "text 70%%, n=500)")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    from multimodal_rare_disease.evaluation.stats import (
        compare_multimodal_vs_unimodal,
        hypothesis_conclusion,
        make_demo_predictions,
        run_statistical_validation,
    )

    if args.demo:
        preds, labels = make_demo_predictions(n=500)
        results = compare_multimodal_vs_unimodal(preds, labels,
                                                 args.n_bootstrap)
    else:
        results = run_statistical_validation(args.results_dir,
                                             args.n_bootstrap)
        if results is None:
            print(f"no prediction dumps (*_predictions.npz) found in "
                  f"{args.results_dir}; run cli.evaluate first or use --demo")
            return 1

    for name, ci in results["confidence_intervals"].items():
        print(f"{name:<12} acc={ci['accuracy']:.3f} "
              f"[{ci['ci_lower']:.3f}, {ci['ci_upper']:.3f}]")
    print()
    for pair, v in results["pairwise"].items():
        print(f"{pair}: chi2 p={v['chi_square']['p_value']:.4f}  "
              f"mcnemar p={v['mcnemar']['p_value']:.4f} "
              f"({v['mcnemar']['method']})")
    print()
    print(hypothesis_conclusion(results))

    if args.demo:
        out = Path(args.results_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "statistical_results.json", "w") as f:
            json.dump(results, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
