"""Streaming rules (the CEP tier) of the port.

``model`` — declarative rule sets (threshold / windowed aggregate /
sequence / absence over device/area/tenant groups) + continuous-rollup
specs, validated and lowered to the device tables of ops/rules.py.
``manager`` — the host runtime: validate-before-swap installs, mtime hot
reload, dedup-keyed alert emission through the normal ingest pipeline,
standby promotion, rollup reads and the rollup archive.
"""

from sitewhere_tpu_torch.rules.manager import RuleSetWatcher, RulesManager
from sitewhere_tpu_torch.rules.model import RuleSet, RuleSetError

__all__ = ["RuleSet", "RuleSetError", "RulesManager", "RuleSetWatcher"]
