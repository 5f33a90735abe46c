"""Command-line interfaces.

Parity with the reference's launcher surface (SURVEY.md L6):
  python -m multimodal_rare_disease.cli.train         (src/train.py, run_training.py, run_multimodal_training.py)
  python -m multimodal_rare_disease.cli.predict       (src/predict.py, predict.py)
  python -m multimodal_rare_disease.cli.evaluate      (src/evaluate.py, evaluate_multimodal.py)
  python -m multimodal_rare_disease.cli.stats         (src/chi_square_test.py)
  python -m multimodal_rare_disease.cli.verify_setup  (verify_setup.py)
  python -m multimodal_rare_disease.cli.augment_data  (scripts/generate_augmented_data.py)
  python -m multimodal_rare_disease.cli.reorganize    (scripts/reorganize_images.py)
  python -m multimodal_rare_disease.cli.generate_synthetic (src/synthetic_image_generator.py)
  python -m multimodal_rare_disease.cli.convert_weights    (offline torch/HF conversion)
  python -m multimodal_rare_disease.cli.explain            (notebooks/explainability.ipynb)
  python -m multimodal_rare_disease.cli.serve              (HTTP serving daemon — beyond the
                                                                reference, which has no serving surface)
"""
