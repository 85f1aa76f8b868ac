"""Connectivity backends (reference sample/conn/): in-process (the dummy
connector + replica stub used by integration tests and single-host
benchmarks) and TCP streams for multi-host deployment."""
