"""The refine step returns its state unchanged: the search runs with no
refine round, the merged top-k left as it is."""
import dataclasses


def plant(sut):
    p = sut.params
    sut.set_params(dataclasses.replace(p, refine_rounds=0))
    return lambda: sut.set_params(p)
