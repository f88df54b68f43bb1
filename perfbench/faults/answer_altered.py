"""One answer altered where it is produced: the first id of each batch's
first query is replaced by the next document's."""


def plant(sut):
    real = sut.entry

    def altered(index, queries, p):
        s, ids, ev = real(index, queries, p)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % index.n_docs
        return s, ids, ev

    sut.entry = altered
    return None
