"""Numerical constants used on the extraction path."""

# number of hand-crafted features produced by candidate scoring
NUM_FEATURES = 46

# sentinel mobility value for data without an ion-mobility dimension
NO_MOBILITY_VALUE = 1e-6

# C13 - C12, the averagine isotope spacing (Da)
MASS_NEUTRON_AVG = 1.0033548378
