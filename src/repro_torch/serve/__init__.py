from repro_torch.serve.engine import RetrievalResult, SeismicServer

__all__ = ["RetrievalResult", "SeismicServer"]
