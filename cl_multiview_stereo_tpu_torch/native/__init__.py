"""The native host loader: ``loader.cc`` (a copy of the JAX package's
``native/loader.cc``, the same C ABI) and its g++ build."""
