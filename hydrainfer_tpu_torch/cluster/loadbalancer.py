"""Round-robin / random load balancers (port of
hydrainfer_tpu/cluster/loadbalancer.py, a copy).

CompositeLoadBalancer routes by a key (ScenarioType) and falls back to any
non-empty sub-balancer when the keyed one has no workers.
"""
import random
from dataclasses import dataclass
from typing import Dict, List, Literal


@dataclass
class LoadBalancerConfig:
    policy: Literal["round", "random"] = "round"


class LoadBalancer:
    def __init__(self, config: LoadBalancerConfig = None):
        self.config = config or LoadBalancerConfig()
        self.workers: List[object] = []
        self._next = 0

    def register_worker(self, worker) -> None:
        self.workers.append(worker)

    def __len__(self):
        return len(self.workers)

    def choice(self):
        assert self.workers, "no workers registered"
        if self.config.policy == "random":
            return random.choice(self.workers)
        w = self.workers[self._next % len(self.workers)]
        self._next += 1
        return w

    def __repr__(self):
        return f"LoadBalancer({self.config.policy}, {len(self.workers)} workers)"


class CompositeLoadBalancer:
    def __init__(self):
        self.balancers: Dict[object, LoadBalancer] = {}

    def register_loadbalancer(self, key, loadbalancer: LoadBalancer) -> None:
        self.balancers[key] = loadbalancer

    def register_worker(self, key, worker) -> None:
        self.balancers[key].register_worker(worker)

    def choice(self, key):
        lb = self.balancers.get(key)
        if lb is not None and len(lb) > 0:
            return lb.choice()
        for lb in self.balancers.values():
            if len(lb) > 0:
                return lb.choice()
        raise RuntimeError("no workers in any balancer")

    def __repr__(self):
        return f"CompositeLoadBalancer({ {k: len(v) for k, v in self.balancers.items()} })"
