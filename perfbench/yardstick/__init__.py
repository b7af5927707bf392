"""The benchmark's yardstick: inputs and weights from the seed, the
table of peaks, the reduction of a profiler trace, the layers' shapes,
the model's operation count and the comparison that decides
``correct``. Nothing here imports the program under test."""
