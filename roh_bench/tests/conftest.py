"""Small panels of the benchmark's configurations for the CPU tests."""

import json
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_config(name: str, snps, nind=None) -> dict:
    """The configuration cut to len(snps) chromosomes of snps loci."""
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    n = len(snps)
    cfg["chromosomes"] = cfg["chromosomes"][:n]
    cfg["chrom_lengths"] = cfg["chrom_lengths"][:n]
    cfg["snps"] = list(snps)
    if nind is not None:
        cfg["individuals"] = nind
    return cfg


@pytest.fixture
def example_small():
    return small_config("garlic-example", (20000, 15000, 10000))


@pytest.fixture
def wgs_small():
    return small_config("kgp3-wgs", (40000, 30000))
