from setuptools import find_packages, setup

setup(
    name="omnidata-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) framework with the capabilities of "
        "EPFL-VILAB/omnidata: steerable multi-task vision dataset pipeline + models"
    ),
    packages=find_packages(include=["omnidata_tpu", "omnidata_tpu.*",
                                    "omnidata_tpu_torch", "omnidata_tpu_torch.*"]),
    package_data={"omnidata_tpu.native": ["*.cpp"],
                  "omnidata_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                         "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "pillow", "scipy", "pyyaml"],
    entry_points={
        "console_scripts": [
            # the reference's pip entry point (settings.ini:17)
            "omnitools.download=omnidata_tpu.data.download:main",
            "omnidata-annotate=omnidata_tpu.annotator.cli:main",
        ]
    },
)
