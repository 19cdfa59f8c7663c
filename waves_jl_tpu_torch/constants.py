"""Material sound-speed constants (the port's own copy of
`waves_jl_tpu/constants.py`)."""

ALUMINIUM = 3100.0
COPPER = 2260.0
BRASS = 2120.0
AIR = 344.0
WATER = 1531.0

DESIGN_SPEED = 3 * AIR

FRAMES_PER_SECOND = 24  # frame rate of the rendered videos
