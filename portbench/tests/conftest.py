"""The benchmark's CPU tests: ``python -m pytest -q portbench/tests`` from
the checkout's root (``-m gpu`` for the one that needs the card)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
