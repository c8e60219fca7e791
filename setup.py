"""Build script for neuronika-tpu's native (C++) components.

    python setup.py build_ext --inplace

Pure CPython C API (no pybind11 in this image). Everything degrades
gracefully to the Python implementations when the extensions are absent.
"""

from setuptools import Extension, setup

setup(
    name="neuronika_tpu",
    version="0.5.0",
    packages=["neuronika_tpu", "neuronika_tpu_torch",
              "neuronika_tpu_torch.models", "neuronika_tpu_torch.ops",
              "neuronika_tpu_torch.optim"],
    # the PyTorch port's CUDA sources, compiled by nvcc at first use
    package_data={"neuronika_tpu_torch": ["csrc/*.cu"]},
    ext_modules=[
        Extension(
            "neuronika_tpu.data._native_ext",
            sources=["csrc/csv_loader.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-march=native"],
        ),
        Extension(
            "neuronika_tpu._engine._native_tape",
            sources=["csrc/tape_walker.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
        Extension(
            "neuronika_tpu.data._native_bpe",
            sources=["csrc/bpe_encoder.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
    ],
)
