"""Per-layer metric readers, one file a metric, found by name.

``metrics/<name>.py`` reads the metric ``<name>``; where that file is not
there, ``metrics/<stem>.py``, the stem being the name up to its first dot
(``device_idle.py`` reads ``device_idle.gen`` and ``device_idle.train``).
Each defines ``read(rec)`` on a traced run's record (``harness.Record``)
and returns the number, or None where it finds nothing to read: the
harness then leaves the metric out of the result line.
"""
