"""The benchmark harness's own tests: CPU, seconds each.  The card's are
marked ``gpu`` and skip elsewhere."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
