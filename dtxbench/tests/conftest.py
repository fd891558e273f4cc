"""Small sizes for the cells that test_dtxbench_harness.TINY does not
hold, added to that table before its tests are collected, at the sizes
each cell's own tests use:

  tdmpc2_317m.control  tests/test_torch_tdmpc2.py's TINY_CONFIG and
                       TINY_TRAFFIC
"""

from dtxbench.tests import test_dtxbench_harness as harness
from tests.test_torch_tdmpc2 import TINY_CONFIG, TINY_TRAFFIC

harness.TINY.setdefault("tdmpc2_317m.control", (TINY_CONFIG, TINY_TRAFFIC))
