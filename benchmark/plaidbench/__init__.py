"""The benchmark harness of nextplaid_tpu_torch.

Everything here belongs to the yardstick: the corpus and query generators,
the table of peaks, the MaxSim work arithmetic, the device-trace reduction,
the comparison that decides `correct`, and the registry that finds a cell's
configuration, traffic mix, driver and per-layer readers by name. It imports
the program only through the drivers, and never the JAX package.
"""
