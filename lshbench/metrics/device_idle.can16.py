"""The share of the traced window with no operation on the device
(`devtrace.idle_share`)."""

from lshbench.devtrace import idle_share as read  # noqa: F401
