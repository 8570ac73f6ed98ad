"""The reference's shipped golden SPD systems (a copy of ``tpucg.io.golden``).

- 2x2: [[2,-1],[-1,2]] x = [1,0], x0 = 0, solution [2/3, 1/3]; float32 CG
  at tol 1e-6 converges in 2 iterations.
- 4x4: eigenvalues ~0.85..11.66, b = [-1,0,-3,1], x0 = 0, solution
  [-1,1,-1,1]; 4 iterations.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

GOLDEN_2X2: Dict[str, np.ndarray] = dict(
    A=np.array([[2.0, -1.0], [-1.0, 2.0]], np.float32),
    b=np.array([1.0, 0.0], np.float32),
    x0=np.zeros(2, np.float32),
    x_star=np.array([2.0 / 3.0, 1.0 / 3.0], np.float32),
    iters=2,
)

GOLDEN_4X4: Dict[str, np.ndarray] = dict(
    A=np.array(
        [
            [7.0, 3.0, -1.0, 2.0],
            [3.0, 8.0, 1.0, -4.0],
            [-1.0, 1.0, 4.0, -1.0],
            [2.0, -4.0, -1.0, 6.0],
        ],
        np.float32,
    ),
    b=np.array([-1.0, 0.0, -3.0, 1.0], np.float32),
    x0=np.zeros(4, np.float32),
    x_star=np.array([-1.0, 1.0, -1.0, 1.0], np.float32),
    iters=4,
)
