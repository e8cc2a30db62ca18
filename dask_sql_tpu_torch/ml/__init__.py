"""The engine's model layer: its own estimators (`torch_models.py`), the
model class names (`ml_classes.py`), metrics and the blockwise wrappers."""
