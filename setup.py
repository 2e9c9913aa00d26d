"""Packaging (reference setup.py: op prebuild via DS_BUILD_* envs,
version stamping). Native host ops prebuild with DS_BUILD_OPS=1 (the JIT
builder handles the default path)."""

import os

from setuptools import find_packages, setup

if os.environ.get("DS_BUILD_OPS", "0") == "1":
    from deepspeed_tpu.ops.op_builder.builder import ALL_OPS
    for name, builder in ALL_OPS.items():
        b = builder()
        if b.is_compatible():
            print(f"prebuilding native op {name}...")
            b.build()

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native large-scale training framework "
                "(DeepSpeed-compatible surface on JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch*"]),
    include_package_data=True,
    install_requires=["jax", "flax", "numpy"],
    entry_points={
        "console_scripts": [
            "deepspeed=deepspeed_tpu.launcher.runner:main",
            "ds=deepspeed_tpu.launcher.runner:main",
            "ds_report=deepspeed_tpu.env_report:cli_main",
            "ds_elastic=deepspeed_tpu.elasticity.elastic_cli:main",
            "ds_ssh=deepspeed_tpu.launcher.ds_ssh:main",
        ],
    },
    python_requires=">=3.10",
)
