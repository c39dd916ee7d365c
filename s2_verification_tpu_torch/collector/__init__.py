from . import adversarial, collect, fake_s2, workloads

__all__ = ["adversarial", "collect", "fake_s2", "workloads"]
