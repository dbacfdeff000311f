from .prng import PRNGSeq
