"""setup_s: seconds from the process's start to the window's first submission (host clock): imports, the CUDA context, the libraries, the entry's objects, one warm request."""

from h100_bench.readers import setup_s as read  # noqa: F401
