from setuptools import setup, find_packages

setup(
    name="pysolvers_tpu",
    version="0.1.0",
    description=("Sparse linear-algebra and iterative-solver framework "
                 "on JAX/XLA"),
    packages=find_packages(include=["pysolvers_tpu", "pysolvers_tpu.*"]),
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
)
