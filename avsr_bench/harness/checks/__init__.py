"""Checks, one module a way of judging ``correct``: ``harness/checks/<check>.py``,
found by a traffic mix's ``check`` key, else its ``entry``
(``check.find``). Each holds:

- ``judge(cell, driver, pool, answers, device, threshold)``: the numbers
  of a window's answers ((pool index, output) a call), judged against the
  plain reference of the driver's family (``harness/check.py`` says how
  they are compared with the cell's limits);
- ``readings(cell, driver, device, pool, threshold)``: the readings a
  cell's limits are set from (``tools/readings.py``): the program's
  ``sound`` answers, the ``control`` (the reference in the nearest
  precision below the configuration's, ``check.CONTROL``, in the
  program's place) and each planted fault, each judged as a run judges
  its window.
"""
