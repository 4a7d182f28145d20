"""``Speech2Text.greedy``: one transcript an utterance, on the host."""

from ..drivers import Driver as _Base


class Driver(_Base):
    def call(self, batch):
        return self.engine.greedy(batch)
