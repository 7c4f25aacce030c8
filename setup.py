"""Build: `python setup.py build_ext --inplace` compiles the native host
ops into hydrainfer_tpu/_C/ (or `make native`). The engine runs without
them — every native component has a pure-Python twin."""
from setuptools import Extension, setup

setup(
    name="hydrainfer_tpu",
    version="0.1.0",
    packages=["hydrainfer_tpu", "hydrainfer_tpu_torch"],
    ext_modules=[
        Extension(
            "hydrainfer_tpu._C.hostops",
            sources=["csrc/hostops.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
    ],
)
