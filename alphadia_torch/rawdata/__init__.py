from alphadia_torch.rawdata.dia_cycle import determine_dia_cycle
from alphadia_torch.rawdata.diadata import DiaData, PeakStore
from alphadia_torch.rawdata.source import SpectrumData, load_npz, load_raw_file, save_npz

__all__ = ["DiaData", "PeakStore", "SpectrumData", "determine_dia_cycle", "load_npz", "load_raw_file", "save_npz"]
