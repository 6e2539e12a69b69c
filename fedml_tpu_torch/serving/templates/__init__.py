"""Serving templates (port of ``fedml_tpu.serving.templates``): the
OpenAI-compatible endpoint."""

from .openai_compat import ByteTokenizer, OpenAICompatServer, generate

__all__ = ["ByteTokenizer", "OpenAICompatServer", "generate"]
