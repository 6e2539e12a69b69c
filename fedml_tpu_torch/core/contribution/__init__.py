"""Contribution assessment (port of ``fedml_tpu.core.contribution``)."""
