"""Copy of garlic_tpu/core/__init__.py: the port imports nothing of garlic_tpu.  Each function and class names its source line."""

