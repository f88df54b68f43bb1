"""The merge keeps the k lowest of the evaluated documents, handed on
highest first: every id and score still matches its document."""
import torch


def plant(sut):
    from repro_torch.retrieval import pipeline
    real = pipeline.merge_topk

    def lowest(cand, scores, k, n_docs):
        neg = torch.where(torch.isfinite(scores), -scores, -torch.inf)
        low, ids, ev = real(cand, neg, k, n_docs)
        s = torch.where(torch.isfinite(low), -low, -torch.inf)
        s, order = torch.sort(s, dim=1, descending=True)
        return s, ids.gather(1, order), ev

    pipeline.merge_topk = lowest

    def undo():
        pipeline.merge_topk = real

    return undo
