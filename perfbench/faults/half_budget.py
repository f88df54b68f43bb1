"""The router and selector hand on half the blocks: the search runs with
half the configuration's block budget."""
import dataclasses


def plant(sut):
    p = sut.params
    sut.set_params(dataclasses.replace(
        p, block_budget=max(1, p.block_budget // 2)))
    return lambda: sut.set_params(p)
