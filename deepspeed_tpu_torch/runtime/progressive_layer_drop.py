"""Progressive layer drop (PLD): the θ(t) stochastic-depth schedule
(counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py``;
reference ``deepspeed/runtime/progressive_layer_drop.py:5``). The engine
passes ``progressive_layer_drop=True, pld_theta=θ`` to the module's
forward, as the reference's ``engine.forward`` does (engine.py:1571)."""

import numpy as np


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, g, p):
            return (1.0 - p) * np.exp(-g * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
