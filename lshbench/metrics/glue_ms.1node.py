"""Device ms a batch outside the program's hand-written kernels
(`devtrace.glue_ms`)."""

from lshbench.devtrace import glue_ms as read  # noqa: F401
