#!/usr/bin/env python
"""Package build (parity: reference python/setup.py + make targets).

    pip install -e . --no-build-isolation   # develop install
    python setup.py build_native  # pre-build the C++ engines (optional —
                                  # native.py also builds them on demand)

The native libraries (RecordIO, JPEG decode, C predict ABI) are built
with the host toolchain through mxnet_tpu.native; no CUDA, no submodules.
"""
import os
import sys

from setuptools import Command, find_packages, setup

HERE = os.path.dirname(os.path.abspath(__file__))


class BuildNative(Command):
    """Ahead-of-time build of the src/*.cc engines into mxnet_tpu/_native."""

    description = "build the native C++ libraries (recordio, imdecode, predict ABI)"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        sys.path.insert(0, HERE)
        from mxnet_tpu import native

        for name, fn in [("recordio", native.get_recordio_lib),
                         ("imdecode", native.get_imdecode_lib),
                         ("predict ABI", native.get_predict_lib_path),
                         ("c_api ABI", native.get_c_api_lib_path)]:
            ok = fn() is not None
            print("  native %-12s %s" % (name, "built" if ok else
                                         "SKIPPED (no toolchain)"))


setup(
    name="mxnet_tpu",
    version="0.1.0",
    description="TPU-native deep-learning framework with the MXNet v0.10 "
                "API surface (JAX/XLA compute, C++ IO/runtime engines)",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    # the PyTorch/CUDA port; its CUDA sources compile at first use
    extras_require={"torch": ["torch"]},
    package_data={"mxnet_tpu": ["_native/*.so"],
                  "mxnet_tpu_torch": ["csrc/*.cu"]},
    cmdclass={"build_native": BuildNative},
)
