"""The portbench tests run from the checkout's root: `python -m pytest
-q portbench/tests` (the tier-1 suite, `tests/`, does not collect them).
The program is put on the path from `src/`, the helpers from here."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
for p in (HERE.parents[1] / "src", HERE.parents[1], HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
