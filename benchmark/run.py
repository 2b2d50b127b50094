"""Run one benchmark cell once, on the card; see ``harness/main.py``."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
# every imported module's bytecode at a fixed path in the checkout, so a
# checkout's later runs load it instead of compiling it again
sys.pycache_prefix = str(HERE.parent / "build" / "bench_cache" / "pycache")

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
