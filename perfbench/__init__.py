"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a cell
needs is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json`` and one reader a per-layer metric in
``metrics/<metric>.py``.  The yardstick (the frozen input generators, the
element-level work counts, the table of peaks, the plain reference and the
comparison that decides ``correct``) lives here, apart from the program.
"""
