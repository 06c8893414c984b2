"""Reporting: ANSI-colored prints, plain-text tables, result files.

Copy of the JAX package's ``io_utils/report.py``.  Mirrors the reference's observability surface (SURVEY.md §5.5):
colored section prints (reference utils.py:130-144), incremental
tabulate tables (bidomain_2d.py:262,271), and append-mode results files
with header-on-first-write semantics (bidomain_2d.py:249-274).
"""
from __future__ import annotations

import os
from functools import partial

GREEN = "\033[1;37;32m%s\033[0m"
RED = "\033[1;37;31m%s\033[0m"
BLUE = "\033[1;37;34m%s\033[0m"


def print_color(color, string):
    """Print with color (kept testable, as the reference notes at
    utils.py:139)."""
    print(color % string)
    return color


print_red = partial(print_color, RED)
print_green = partial(print_color, GREEN)
print_blue = partial(print_color, BLUE)


def tabulate_simple(rows, headers):
    """Minimal fixed-width table (tabulate-lookalike, no dependency)."""
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)
    cells = [[fmt(v) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    out = ["  ".join(h.rjust(w) for h, w in zip(headers, widths))]
    out.append("  ".join("-" * w for w in widths))
    for r in cells:
        out.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


class ResultWriter:
    """Append-mode result file with headers written on first refinement
    (bidomain_2d.py:249-265 semantics). Filename encodes the full config
    (bidomain_2d.py:133-135)."""

    def __init__(self, path, headers):
        self.path = path
        self.headers = list(headers)
        self._started = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write_row(self, row):
        mode = "a" if self._started else "w"
        with open(self.path, mode) as out:
            if not self._started:
                out.write("%s\n" % " ".join(self.headers))
                self._started = True
            out.write("%s\n" % " ".join(map(str, row)))
