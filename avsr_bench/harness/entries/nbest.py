"""``Speech2Text.nbest``: the family's search (the joint CTC/attention beam
with LM fusion for the tailored and Branchformer models); per utterance
its n-best [(text, tokens, ids, score)]."""

from .. import flops
from ..drivers import Driver as _Base


class Driver(_Base):
    uses_lm = True
    search_flops = staticmethod(flops.beam_memory_flops)  # the decoder's cross-attention K and V

    def call(self, batch):
        return self.engine.nbest(batch)
