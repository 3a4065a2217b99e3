"""The benchmark's machinery: one general driver for every cell.

Nothing here names a cell.  A cell's configuration, traffic mix, kind of
unit, limits, metric readers, roofline counts and faults are files found by
name (:mod:`harness.spec`), so a later change adds a cell, a kind of unit
or a metric by adding files and ``BENCHMARK.json`` entries alone.
"""
