"""The types a commit verification needs: BlockID, Vote, Validator, Commit,
AggregateCommit, ValidatorSet and VoteSet. Block, Header and PartSet come
with a later slice of the port."""
