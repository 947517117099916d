"""Version strings.

OUTPUT_COMPAT_VERSION is the GARLIC version whose output formats (BED track
headers, log lines) we reproduce byte-for-byte (reference:
src/garlic-cli.cpp:4 `const string VERSION = "1.1.6a"`).

Copy of garlic_tpu/version.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

__version__ = "0.1.0"
OUTPUT_COMPAT_VERSION = "1.1.6a"
