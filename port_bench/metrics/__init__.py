"""Per-layer metric readers, one file a metric (or a family of metrics
that share the part of their name before the first dot).  Each has
``read(run, summary, name)``, which returns the metric or None where the
trace holds nothing to read, and may name the program attributes it
wants spans around in ``SPANS`` (span name -> ``"module:attribute"``)."""
