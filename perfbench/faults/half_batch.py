"""Half of each batch left out: the timed entry answers the first half
and hands its answers on for the rest."""
import torch


def plant(sut):
    real = sut.entry

    def half(index, queries, p):
        s, ids, ev = real(index, queries, p)
        n = ids.shape[0]
        h = n // 2
        return (torch.cat([s[:h], s[:n - h]]),
                torch.cat([ids[:h], ids[:n - h]]),
                torch.cat([ev[:h], ev[:n - h]]))

    sut.entry = half
    return None
