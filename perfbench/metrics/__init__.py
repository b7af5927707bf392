"""One reader a quantity: ``perfbench/metrics/<quantity>.py`` reads every
per-layer metric named ``<quantity>`` or ``<quantity>.<part>``. Its
``read(readings, part)`` gets the run's readings
(``perfbench.drivers.common.Readings``) and the part of the name after
the first dot (None without one), and returns the value, or None where
the run holds nothing for that metric to read. Unit, layer, source and
the metric it moves are declared in ``BENCHMARK.json`` alone. A share of
a roofline or of a peak is never reported as 0 for want of a reading."""
