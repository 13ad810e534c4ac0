"""n-best diffusion-likelihood rescoring: pickle n-best lists, batched
likelihood scoring on the GPU, score compilation, linear rescoring + WER,
and TPE weight search. The public names of gradtts_tpu/nbest/__init__.py.
"""

from gradtts_tpu_torch.nbest.lists import (  # noqa: F401
    NBestList, SCORE_NAMES, load_n_best, save_n_best, make_synthetic_n_best,
)
from gradtts_tpu_torch.nbest.wer import wer, wer_details, edit_counts  # noqa: F401
from gradtts_tpu_torch.nbest.scoring import (  # noqa: F401
    NBestScorer, score_batch, score_n_best, compile_scores,
)
from gradtts_tpu_torch.nbest.rescoring import (  # noqa: F401
    rescoring_wer, select_hypotheses, evaluate, weights_vector,
)
from gradtts_tpu_torch.nbest.sweep import (  # noqa: F401
    tpe_minimize, refine, DEFAULT_SPACE,
)
