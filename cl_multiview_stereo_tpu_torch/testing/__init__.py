"""Test support: synthetic scenes (a copy of the JAX package's
``testing.synthetic``)."""
