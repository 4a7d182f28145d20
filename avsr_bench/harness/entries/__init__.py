"""Entries, one module an entry point of the program: ``harness/entries/<entry>.py``,
found by a traffic mix's ``entry`` (``drivers.make``). Each holds
``Driver``, a subclass of ``drivers.Driver`` whose ``call(batch)`` makes
one call of the entry and returns what the check judges; ``uses_lm``
says whether the entry fuses the configuration's LM, and
``search_flops(cfg, b, t)`` counts what its search adds, before its steps,
over the encoder's output (0 by default).
"""
