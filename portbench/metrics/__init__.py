"""One reader a per-layer metric, ``<module>.py`` as
``harness.metric_module`` names it, each with ``read(run, cell)``."""
