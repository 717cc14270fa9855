"""AutoQ core of the port: hierarchical DRL search for kernel-wise
quantization (port of ``repro/core``).

  env.QuantEnv            -- model-agnostic quantization MDP (Eq. 1 states)
  agent.HierarchicalAgent -- HLC + LLC DDPG with HIRO goal relabeling
  flat.FlatAgent          -- layer-level (HAQ-like) / flat-channel baselines
  reward                  -- NetScore / FLOP / roofline extrinsic rewards
  bound.LayerBounder      -- Algorithm 1 resource-constrained action limiting
  search.run_search       -- explore / exploit episode schedule
  evaluate                -- QuantPolicy -> accuracy evaluators on kernels
                             B5 (fake-quant) and B6 (bit-plane product)
  roofline                -- latency / energy models for the roofline
                             reward: the reference's TPURoofline (a copy)
                             and the port's H100Roofline
"""
from repro_torch.core.agent import HierarchicalAgent
from repro_torch.core.bound import LayerBounder
from repro_torch.core.ddpg import DDPG, DDPGConfig, ReplayBuffer
from repro_torch.core.env import QuantEnv
from repro_torch.core.evaluate import make_cnn_evaluator, make_lm_evaluator
from repro_torch.core.flat import FlatAgent
from repro_torch.core.reward import RewardCfg, extrinsic_reward, netscore
from repro_torch.core.roofline import H100Roofline, TPURoofline
from repro_torch.core.search import SearchResult, run_search

__all__ = [
    "HierarchicalAgent", "LayerBounder", "DDPG", "DDPGConfig", "ReplayBuffer",
    "QuantEnv", "make_cnn_evaluator", "make_lm_evaluator", "FlatAgent",
    "RewardCfg", "extrinsic_reward", "netscore", "H100Roofline",
    "TPURoofline", "SearchResult", "run_search",
]
