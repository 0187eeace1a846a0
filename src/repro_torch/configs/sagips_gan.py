"""The paper's own workload: the SAGIPS GAN loop-closure configuration (§V),
as `repro.configs.sagips_gan` has it.

`PAPER` is Tab. III at the paper's widths; `REDUCED` keeps its structure
at CPU scale.  `for_problem` retargets either preset at any registered
problem; image-valued problems (the conv generator) get the JAX
package's retuned batch shape and capped generator step.
"""
import dataclasses

from ..core.sync import SyncConfig
from ..core.workflow import WorkflowConfig

# Tab. III settings
PAPER = WorkflowConfig(
    sync=SyncConfig(mode="rma_arar_arar", h=1000),   # best mode, h from §V-C
    n_param_samples=1024,
    events_per_sample=100,
    data_fraction=0.5,
    gen_lr=1e-5,
    disc_lr=1e-4,
    problem="proxy1d",
)

# reduced settings for CPU-scale convergence studies (same structure)
REDUCED = WorkflowConfig(
    sync=SyncConfig(mode="rma_arar_arar", h=50),
    n_param_samples=64,
    events_per_sample=25,
    data_fraction=0.5,
    gen_lr=2e-4,
    disc_lr=5e-4,
    problem="proxy1d",
)

# image-valued problems (the conv generator): the JAX package's retuning
IMAGE_PARAM_SAMPLES = 64
IMAGE_EVENTS_PER_SAMPLE = 32
IMAGE_MAX_GEN_LR = 5e-5


def for_problem(problem: str, base: WorkflowConfig = REDUCED
                ) -> WorkflowConfig:
    """Retarget a preset at another registered inverse problem (a KeyError
    names the registered ones).  Problems with an image-valued
    `param_shape` also get the image batch shape and a capped generator
    step, as in the JAX package."""
    from ..problems import get_problem
    prob = get_problem(problem)              # fail fast on unknown names
    cfg = dataclasses.replace(base, problem=problem)
    if prob.param_shape is not None:
        cfg = dataclasses.replace(
            cfg,
            n_param_samples=min(cfg.n_param_samples, IMAGE_PARAM_SAMPLES),
            events_per_sample=IMAGE_EVENTS_PER_SAMPLE,
            gen_lr=min(cfg.gen_lr, IMAGE_MAX_GEN_LR))
    return cfg


def throughput(base: WorkflowConfig = REDUCED, disc_every: int = 2
               ) -> WorkflowConfig:
    """The JAX package's throughput variant of a preset: the bf16 ring
    payload against fp32 master state, and a discriminator update every
    `disc_every` epochs (the off-epochs run the generator's half alone,
    `core.workflow.due`)."""
    return dataclasses.replace(
        base, sync=dataclasses.replace(base.sync, payload_precision="bf16"),
        disc_every=disc_every)
