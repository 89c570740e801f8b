"""C++ sources of the port's native host helpers (the FLAC decoder
and the PNG scanline filter).

Shipped inside the package (package data), so an installed copy compiles
them on first use as a checkout does: io/_native.py builds each with g++
into build/gomel_tpu_torch/native/ and falls back to the pure-Python
implementation, with a one-time warning, where no toolchain exists.
"""
