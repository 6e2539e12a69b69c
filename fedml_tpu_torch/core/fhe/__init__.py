"""Homomorphic-encryption aggregation (port of ``fedml_tpu.core.fhe``)."""
