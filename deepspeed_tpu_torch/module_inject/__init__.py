"""Module injection: int8 weight quantization for inference."""
