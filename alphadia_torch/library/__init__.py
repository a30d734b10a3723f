from alphadia_torch.library.speclib import SpecLibFlat

__all__ = ["SpecLibFlat"]
