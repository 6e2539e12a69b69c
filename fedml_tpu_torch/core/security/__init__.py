"""The trust stack's attacks and defenses (port of
``fedml_tpu.core.security``)."""
