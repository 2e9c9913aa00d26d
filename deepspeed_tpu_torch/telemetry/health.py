"""Strict-JSON helper of the training-health observatory (counterpart of
``json_safe`` in ``deepspeed_tpu/telemetry/health.py``; the rest of that
module, the training-health monitor, is not ported yet)."""

import math


def json_safe(obj):
    """Recursively replace non-finite floats with their string names.

    ``json.dump`` would otherwise emit bare ``Infinity``/``NaN`` tokens,
    which jq, ``JSON.parse`` and Go reject; strings keep them readable
    and the file valid JSON."""
    if isinstance(obj, float):
        if math.isnan(obj):
            return "NaN"
        if math.isinf(obj):
            return "Infinity" if obj > 0 else "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj
