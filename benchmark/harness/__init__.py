"""The benchmark's yardstick: seeded inputs, the device-trace reduction, the
chip's peaks, the comparison that decides ``correct`` and the run loop that
ties a cell's configuration, traffic, driver and metrics together."""
