"""Scene constants: the default sun (scene.h:22-23).

Counterpart of the constants at the top of
`voxel_tracer_tpu/models/scene.py`; the multi-volume `Scene` itself comes
with a later slice of the port.
"""

import numpy as np

SUN_DIR = np.array([-0.619501, 0.465931, -0.631765], np.float32)  # scene.h:22
SUN_LIGHT = np.array([0.95, 0.93, 0.875], np.float32)             # scene.h:23
