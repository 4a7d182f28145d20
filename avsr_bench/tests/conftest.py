"""The benchmark's own tests: the harness's arithmetic, the traffic, the
manifest, the reference against the program at tiny sizes on the CPU, and
(marked ``card``) the control on the card.

python -m pytest avsr_bench/tests -q          # the CPU tests, seconds
python -m pytest avsr_bench/tests -q -m card  # on the card
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one (decided inside the test)")
