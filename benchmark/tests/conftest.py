"""The benchmark's CPU tests import the harness and the reference as the
benchmark does (``benchmark/`` and the checkout's root on the path)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
