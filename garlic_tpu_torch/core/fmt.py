"""C++-iostream-compatible scalar formatting.

The reference writes doubles through `ostream <<` with default precision 6,
which is equivalent to printf "%g" (reference: src/garlic-errlog.cpp:362-371,
src/garlic-kde.cpp:286, src/garlic-roh.cpp:632-638).  All comparison artifacts
(.log, .kde, .freq.gz, .roh.bed) use this formatting, so we reproduce it here.

Copy of garlic_tpu/core/fmt.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

from __future__ import annotations


def g(x) -> str:
    """Format a float the way `std::ostream << double` does (printf %g, prec 6).

    Copy of garlic_tpu/core/fmt.py:12."""
    if isinstance(x, bool):
        return "TRUE" if x else "FALSE"
    if isinstance(x, int):
        return str(x)
    return f"{float(x):g}"
