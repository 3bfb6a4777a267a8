from repro_torch.data.synthetic import SyntheticLM, make_batch

__all__ = ["SyntheticLM", "make_batch"]
