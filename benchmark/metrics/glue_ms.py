"""Milliseconds a clip that the pipeline spends outside its timed phases
(text, denoise steps, decodes, staging): GenerationTimings.total minus them."""


def read(run):
    if not run.clips:
        return None
    glue = [c["total"] - c["text"] - sum(c["steps"]) - c["decode"] - c["other_phases"]
            for c in run.clips]
    return 1e3 * sum(glue) / len(glue)
