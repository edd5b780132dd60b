from gyeeta_tpu_torch.sim.partha import ParthaSim

__all__ = ["ParthaSim"]
