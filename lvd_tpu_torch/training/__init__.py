"""Diffusion training: the eps-prediction loss, AdamW, full or adapter-only
(training/train.py)."""
