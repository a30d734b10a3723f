from alphadia_torch.rawdata.dia_cycle import determine_dia_cycle
from alphadia_torch.rawdata.diadata import DiaData
from alphadia_torch.rawdata.source import SpectrumData

__all__ = ["DiaData", "SpectrumData", "determine_dia_cycle"]
