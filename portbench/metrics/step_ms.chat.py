"""Window wall time per engine iteration (``InferenceEngine.step``), from the
engine's ``StepRecord`` ring."""
from portbench.readers import step_ms


def read(run):
    return step_ms(run)
