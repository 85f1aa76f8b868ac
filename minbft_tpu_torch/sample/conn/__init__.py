"""Connectivity backends (reference sample/conn/): in-process (the dummy
connector + replica stub used by integration tests and single-host
benchmarks), and for one process per replica the native length-prefixed
TCP framing (``tcp``) and gRPC bidi streams (``grpc``)."""
