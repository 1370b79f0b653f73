"""The benchmark's own tests: `python -m pytest lshbench/tests` from the
root of the repository.  The harness and the program are imported from
the checkout."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
