"""The port's command-line programs, run as modules:
``python -m mojosplat_tpu_torch.examples.train_colmap`` and
``python -m mojosplat_tpu_torch.examples.eval_colmap``."""
