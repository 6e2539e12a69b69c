"""Differential privacy (port of ``fedml_tpu.core.dp``)."""
